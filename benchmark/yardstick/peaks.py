"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; the full
700 W power limit): the denominators of the rooflines."""

#: streaming multiprocessors, lanes (FP32/INT32 cores) of one, boost clock
SMS, LANES_PER_SM, CLOCK_HZ = 132, 128, 1.98e9
#: lane operations a second: one 32-bit operation a lane a cycle
LANE_OPS_PER_S = SMS * LANES_PER_SM * CLOCK_HZ
#: HBM3 bytes a second
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: operations at the lane rate or
    bytes at the memory's rate, whichever is longer."""
    return max(ops / LANE_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
