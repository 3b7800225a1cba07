"""Operations the Monte-Carlo work needs, counted from the code's shape and
the algorithm, never from an implementation: the numerators of the
rooflines.

Frozen copies of the port's counted arithmetic (``LANE_OPS``,
``mc_chain_ops_per_symbol``, ``STACK_OPS``, ``stack_pick_ops``,
``datagen_ops_per_symbol`` in ``chip_smoke.py``), for the codes of 1-4
coded bits a symbol, and the Fano walk's step counted the same way
(``FANO_OPS``).  A code is any object with the fields of
``benchmark.reference.common.CodeSpec``.
"""

from __future__ import annotations

import numpy as np

#: per-lane operations of the fused chain's pieces: a hash (3 shifts, 3
#: xors and 2 multiplies each of its two rounds, the index's multiply-add
#: and the salt's xor), a uniform from its bits (shift, convert, multiply,
#: add), one ACS state (two branch-metric reads, two adds, a compare, a
#: select, the decision bit), one traceback row (the survivor bit, the
#: decoded bit, the next state), and Box-Muller's logf, sqrtf and sincosf
#: at the lengths of their single-precision fast paths (about 20, 7 and 22)
LANE_OPS = {"hash": 18, "uniform": 4, "acs_state": 8, "traceback_row": 9,
            "transcendentals": 20 + 7 + 22}


def mc_chain_ops_per_symbol(code) -> float:
    """Operations per lane and trellis symbol of the fused chain on AWGN
    with soft metrics: the info bit's hash and mask on the rows below L;
    the encoder register and its expected symbol (5); two uniforms;
    Box-Muller (the transcendentals, 2 pi u and -2 log u, then r c and r s,
    scaled by sigma and added to the point: 10 more); a distance a point (2
    subtractions, 2 squares, an add, a scale); the ACS of every state; one
    traceback row."""
    o = LANE_OPS
    ops = code.block_length / code.num_block_symbols * (o["hash"] + 1) + 5
    ops += 2 * (o["hash"] + o["uniform"]) + o["transcendentals"] + 10
    ops += 6 * code.points_per_symbol
    return ops + o["acs_state"] * code.num_states + o["traceback_row"]


#: operations of the stack walk's function.  The pick of an iteration's
#: first max and first min at its least, as the kept best/worst of 8 groups
#: of 8 slots needs it: per live group, for its kept max and its kept min
#: each a read, a compare and two selects (8); the winners' two slots read
#: and the rewritten group's max, min and slots stored (6); and that group
#: rescanned, per live slot a read, two compares and four selects (7).  Per
#: iteration besides: the best path's node (a read, its two fields, the
#: symbol accepted: 6), per branch its register (2), per coded bit of its
#: expected symbol 4 (and, popcount, parity, place), its metric (soft: a
#: read, a product, an add; hard: a read and 5), the two slots written (two
#: metric adds, two node words, four stores, the capacity test: 12), and per
#: word of the path copied a read, an or and a write
STACK_OPS = {"pick_group": 8, "pick": 6, "pick_slot": 7, "node": 6, "branch": 2,
             "coded_bit": 4, "soft_metric": 3, "hard_metric": 6, "write": 12, "path_word": 3}
STACK_DEPTH, STACK_GROUP = 64, 8

#: operations of one forward SEARCH step of the Fano walk, counted the
#: same way: the current node's record read (state, metric, the selected
#: branch's metric: 3) and the sum and its compare with the threshold (2);
#: the tightening test and the closed form of its loop (a subtract, a
#: divide, a floor, two compares, a product and an add: 8); the budget's
#: decrement and test (2); the entered node's record written (state,
#: metric, selection, 4); per branch of the entered node its register (2),
#: per coded bit 4 and its metric (soft: a read, a product, an add; hard: a
#: read and 5), and the two branches sorted (a compare, four selects: 5)
FANO_OPS = {"node": 3, "search": 2, "tighten": 8, "budget": 2, "write": 4, "branch": 2,
            "coded_bit": 4, "soft_metric": 3, "hard_metric": 6, "sort": 5}


def stack_pick_ops(iters, frames: int) -> float:
    """The pick's operations (STACK_OPS) summed over walks of ``iters``
    iterations (a 1-D array), where iteration i has min(i, 64) live slots:
    exact where each entry is one walk; where each entry sums ``frames``
    walks, the least that sum can be (a walk's count is convex in its
    iterations)."""
    o, n = STACK_OPS, np.arange(1, STACK_DEPTH + 1)
    per = (o["pick_group"] * -(-n // STACK_GROUP) + o["pick"]
           + o["pick_slot"] * np.minimum(n, STACK_GROUP))
    done = np.concatenate([[0], np.cumsum(per)])
    x = np.asarray(iters, dtype=np.float64) / frames
    k = np.minimum(np.floor(x), STACK_DEPTH).astype(np.int64)
    return float((done[k] + (x - k) * per[np.minimum(k, STACK_DEPTH - 1)]).sum()) * frames


def datagen_ops_per_symbol(code, channel: str) -> float:
    """A walk's data generation a symbol (LANE_OPS): the info bit's hash,
    the encoder register and expected symbol (5); on AWGN two uniforms,
    Box-Muller (as the fused chain's) and per point a distance (6), its
    metric (product, add) and its store; on the BSC a uniform and a compare
    per coded bit and per point a hard metric (5) and its store."""
    o, M = LANE_OPS, code.points_per_symbol
    ops = o["hash"] + 1 + 5
    if channel == "awgn":
        return ops + 2 * (o["hash"] + o["uniform"]) + o["transcendentals"] + 10 + 9 * M
    return ops + code.symlen_out * (o["hash"] + o["uniform"] + 2) + 6 * M


def frame_datagen_ops(code, channel: str) -> float:
    """A frame's data generation and the count of its bit errors (a hash, a
    mask, a compare and an add per info bit)."""
    return (code.num_block_symbols * datagen_ops_per_symbol(code, channel)
            + code.block_length * (LANE_OPS["hash"] + 3))


def stack_ops(code, channel: str, iters, frames: int) -> float:
    """Operations of the stack walks over ``iters`` iterations (each entry
    the sum of ``frames`` walks), with each frame's data generation."""
    o = STACK_OPS
    metric = o["soft_metric"] if channel == "awgn" else o["hard_metric"]
    per_iter = (o["node"] + 2 * (o["branch"] + o["coded_bit"] * code.symlen_out + metric)
                + o["write"] + o["path_word"] * -(-code.block_length // 32))
    iters = np.asarray(iters, dtype=np.float64)
    return (stack_pick_ops(iters, frames) + per_iter * float(iters.sum())
            + iters.size * frames * frame_datagen_ops(code, channel))


def fano_step_ops(code, channel: str) -> float:
    """Operations of one forward SEARCH step of the Fano walk (FANO_OPS)."""
    o = FANO_OPS
    metric = o["soft_metric"] if channel == "awgn" else o["hard_metric"]
    return (o["node"] + o["search"] + o["tighten"] + o["budget"] + o["write"]
            + 2 * (o["branch"] + o["coded_bit"] * code.symlen_out + metric) + o["sort"])


def least_walk_ops(code, channel: str, decoder: str, frames: int) -> float:
    """The least operations ``frames`` Monte-Carlo frames of a sequential
    decoder need: each frame's data generation and one walk step per coded
    symbol (T iterations a frame, the fewest a walk to the end takes)."""
    T = code.num_block_symbols
    if decoder == "stack":
        return stack_ops(code, channel, np.full(1, float(T * frames)), frames)
    if decoder == "fano":
        return frames * (frame_datagen_ops(code, channel) + T * fano_step_ops(code, channel))
    raise ValueError(f"not a sequential decoder: {decoder!r}")
