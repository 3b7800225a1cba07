"""PyTorch port, the ``fast_demap`` variant of the fused chain (kernel 3):
the twin of ``tests/test_fused_variants.py`` for the port.

``fast_demap`` replaces the squared-distance vector by its linear form
(the JAX package's ``dist_vec_lin``, fused_chain.py:212-246).  Checks:
  (a) the algebra: the port's linear vector minus its exact one is one
      constant per position (codes 0, 5 and k15-r14-16qam), to a few ulp
      of the largest metric, as the JAX test;
  (b) against the JAX package's vector: the port's ``_dist_vec_lin``
      equals ``_stage_fns(code, fast_demap=True)``'s on the same numpy
      inputs to at most 1 ulp (XLA-CPU may contract a product into the
      following add; the count of exact matches is printed), and the
      kernel's form of it (``lin_params``, evaluated in float32 numpy with
      no contraction) equals it exactly;
  (c) the counters: the port's plain chain with ``variant="fast_demap"``
      against the JAX interpret-mode kernel with the same variant, code 0
      at 5 dB, 512 lanes x 4 steps, seed 11: the hash streams are shared,
      so the lanes that differ are counted and printed, and the totals must
      pass the clustered two-sample |z| < 4.5 (Box-Muller's transcendentals
      differ in the last ulp between torch and XLA);
  (d) tokens other than ``fast_demap`` raise, saying why.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.ops import fused_chain as jfc
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops import fused_chain as fc
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

CODES = [0, 5, "k15-r14-16qam"]
Z_MAX = 4.5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: torch's float32 transcendentals on the CPU split
    tensors of more than 2048 elements between threads, and the second
    thread's share has come out off (ROADMAP Q3)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _received(n: int = 4096):
    rng = np.random.default_rng(3)
    return (rng.normal(0, 1, n).astype(np.float32), rng.normal(0, 1, n).astype(np.float32))


@pytest.mark.parametrize("ck", CODES)
def test_linear_form_is_exact_minus_common_shift(ck):
    tables = code_tables(get_code(ck), torch.device("cpu"))
    rxi, rxq = (torch.as_tensor(x) for x in _received())
    de = fc._dist_vec(tables, rxi, rxq).numpy()
    dl = fc._dist_vec_lin(tables, rxi, rxq).numpy()
    shift = dl - de                                           # [M, N]
    spread = shift.max(axis=0) - shift.min(axis=0)
    tol = 1e-5 * np.maximum(np.abs(de).max(axis=0), 1.0)
    assert (spread <= tol).all()


@pytest.mark.parametrize("ck", CODES)
def test_linear_form_matches_jax(ck):
    rxi, rxq = _received()
    _, _, _, dist_lin, _ = jfc._stage_fns(jax_code(ck), fast_demap=True)
    ref = np.stack([np.asarray(d) for d in dist_lin(jnp.asarray(rxi), jnp.asarray(rxq))])
    tables = code_tables(get_code(ck), torch.device("cpu"))
    ours = fc._dist_vec_lin(tables, torch.as_tensor(rxi), torch.as_tensor(rxq)).numpy()
    exact = ours == ref
    ulps = np.abs(ours - ref) / np.spacing(np.maximum(np.abs(ours), np.abs(ref)))
    print(f"{ck}: {int(exact.sum())} of {exact.size} distances equal to JAX's bit for bit, "
          f"the largest difference {ulps.max():.0f} ulp")
    assert (ulps <= 1).all()
    # the kernel's form: (rxi ci + rxq cq) + pe2 in float32, no contraction
    ci, cq, pe2 = fc.lin_params(tables)
    kern = (rxi[None] * ci[:, None] + rxq[None] * cq[:, None]) + pe2[:, None]
    assert kern.dtype == np.float32 and np.array_equal(kern, ours)


def test_counters_match_jax_interpret():
    code = get_code(0)
    sig = float(awgn_sigma(5.0))
    kw = dict(block_lanes=512, variant="fast_demap")
    e_j, f_j = jfc.mc_chain_viterbi(jax_code(0), 512, 4, 11, sig, interpret=True, **kw)
    e_t, f_t = fc.mc_chain_viterbi_ref(code, 512, 4, 11, sig, **kw)
    e_j, f_j = np.asarray(e_j), np.asarray(f_j)
    e_t, f_t = e_t.numpy(), f_t.numpy()
    differ = int(((e_t != e_j) | (f_t != f_j)).sum())
    nj, nt = int(e_j.sum()), int(e_t.sum())
    print(f"fast_demap, code 0 at 5 dB, 512 lanes x 4 steps: {differ} lanes differ; "
          f"bit errors {nt} (port) and {nj} (JAX)")
    assert nj > 50
    cluster = max(1.0, (nj + nt) / max(1, int(f_j.sum()) + int(f_t.sum())))
    assert abs(nt - nj) <= Z_MAX * np.sqrt(cluster * (nt + nj))
    # the exact demapper on the same streams: a different float result
    e_x, _ = fc.mc_chain_viterbi_ref(code, 512, 4, 11, sig, block_lanes=512)
    assert abs(nt - int(e_x.sum())) <= Z_MAX * np.sqrt(cluster * (nt + int(e_x.sum())))


@pytest.mark.parametrize("variant, match", [
    ("nope", "no such token"), ("bf16_acs", "TPU closed"),
    ("fast_demap,no_tb", "ablation"), ("cheap_bm", "ablation")])
def test_other_tokens_raise(variant, match):
    for run in (fc.mc_chain_viterbi, fc.mc_chain_viterbi_ref):
        with pytest.raises(ValueError, match=match):
            run(get_code(0), 64, 1, 0, 0.5, block_lanes=64, device="cpu", variant=variant)


def test_variant_reaches_the_plain_chain():
    """On the CPU the wrapper hands the variant to the plain version; on
    the BSC it changes nothing (hard metrics)."""
    code, sig = get_code(0), float(awgn_sigma(3.0))
    lin = fc.mc_chain_viterbi(code, 256, 2, 7, sig, block_lanes=256, device="cpu",
                              variant="fast_demap")
    ref = fc.mc_chain_viterbi_ref(code, 256, 2, 7, sig, block_lanes=256, variant="fast_demap")
    assert all(torch.equal(a, b) for a, b in zip(lin, ref))
    snap = fc.mc_chain_viterbi_ref(code, 256, 2, 7, sig, block_lanes=256, demapper="hard",
                                   variant="fast_demap")
    assert int(snap[0].sum()) > 0
    bsc = [fc.mc_chain_viterbi_ref(code, 256, 2, 7, 0.05, "bsc", block_lanes=256, variant=v)
           for v in ("", "fast_demap")]
    assert all(torch.equal(a, b) for a, b in zip(*bsc))
