from convolutional_codes_tpu_torch.parallel.mesh import make_mesh, frames_axis_size
from convolutional_codes_tpu_torch.parallel.montecarlo import (
    sharded_accumulate, sweep_grid_accumulate, fused_mc_accumulate,
    fused_mc_eligible)
from convolutional_codes_tpu_torch.parallel.streaming import (
    streaming_viterbi_decode, monolithic_reference_decode)

__all__ = ["make_mesh", "frames_axis_size", "sharded_accumulate",
           "sweep_grid_accumulate", "fused_mc_accumulate",
           "fused_mc_eligible", "streaming_viterbi_decode",
           "monolithic_reference_decode"]
