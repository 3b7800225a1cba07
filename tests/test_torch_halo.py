"""PyTorch port, the time-block decode's halo exchange across processes
(``parallel/streaming.streaming_viterbi_decode`` on a ``seq`` mesh that
spans processes): two processes over gloo on localhost, with one and with
two CPU slots each, decode the same noisy nasa-k7 stream; the bits of
every process equal the one-process decode over the same slots and the
exact decode (``long_frame_decode_stream``).

Tolerances: exact (the halos are the same float32 symbols whichever way
they travel, and each block runs the same plain ACS and traceback).
"""

import numpy as np
import torch

from tests import two_process

B, T, W, SNR_DB, SEED = 2, 1024, 96, 4.0, 5

#: the stream both sides decode, from numpy: (code, [B, T, M] distances)
STREAM = r"""
import numpy as np
import torch
torch.set_num_threads(1)
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.ops.demapper import soft_demap
from convolutional_codes_tpu_torch.ops.encoder import encode_stream
from convolutional_codes_tpu_torch.ops.mapper import map_symbols


def noisy_stream(B, T, snr_db, seed):
    code = get_code("nasa-k7")
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(rng.integers(0, 2, (B, T - code.constraint_length + 1)),
                           dtype=torch.int32)
    iq = map_symbols(code, encode_stream(code, bits, terminate=True))
    noise = rng.normal(0.0, float(awgn_sigma(snr_db)), tuple(iq.shape))
    return code, soft_demap(code.symlen_out, iq + torch.as_tensor(noise, dtype=torch.float32))
"""

#: run by each process: argv = local CPU slots
WORKER = STREAM + two_process.JOIN + f"""
import json, sys
from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
from convolutional_codes_tpu_torch.parallel.streaming import streaming_viterbi_decode

code, dists = noisy_stream({B}, {T}, {SNR_DB}, {SEED})
mesh = make_mesh({{"seq": -1}}, devices=[torch.device("cpu")] * int(sys.argv[1]))
bits = streaming_viterbi_decode(code, dists, mesh, warmup={W})
print(json.dumps({{"joined": joined, "world": mesh.world, "rank": mesh.rank,
                  "slots": mesh.size, "bits": bits.tolist()}}))
""" + two_process.LEAVE


def test_two_processes_decode_as_one():
    ns = {}
    exec(STREAM, ns)
    code, dists = ns["noisy_stream"](B, T, SNR_DB, SEED)
    from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
    from convolutional_codes_tpu_torch.parallel.streaming import (
        long_frame_decode_stream, streaming_viterbi_decode)

    ports = two_process.free_ports(2)               # both pairs side by side
    pairs = {n: two_process.Pair(WORKER, n, port=port) for n, port in zip((1, 2), ports)}
    exact = long_frame_decode_stream(code, dists)
    for n, pair in pairs.items():
        one = streaming_viterbi_decode(
            code, dists, make_mesh({"seq": 2 * n}, devices=[torch.device("cpu")] * (2 * n)),
            warmup=W)
        assert torch.equal(one, exact), n          # the one-process decode is exact here
        for rank, got in enumerate(pair.results()):
            assert got["joined"] and (got["world"], got["rank"], got["slots"]) == (2, rank, 2 * n)
            assert np.array_equal(np.asarray(got["bits"], dtype=np.int32), one.numpy()), (n, rank)
    assert 0 < int(exact.sum()) < exact.numel()
