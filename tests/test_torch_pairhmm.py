"""The port's pair-HMM (longtr_tpu_torch.ops) against longtr_tpu's.

The plain torch scan must be bit-identical (np.array_equal, tolerance zero)
to every f32 scorer of the JAX package: the jnp scan, both Pallas kernels
in interpret mode (resident K1 and the read-chunked K2), and the native
C++ scorer.  Against the f64 oracle it is held to the f32-rounding
tolerance tests/test_pairhmm.py uses (atol 2e-2).  The batches come from
tests/test_torch_cuda.py, whose `gpu` tests hold both CUDA kernels to the
same bits on a card.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from longtr_tpu import native
from longtr_tpu.ops import pairhmm as jax_pairhmm
from longtr_tpu.ops.pairhmm_pallas import pairhmm_batch_pallas
from longtr_tpu_torch.ops import pairhmm as port
from longtr_tpu_torch.ops import pairhmm_cuda

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cuda import CASES, CUSTOM  # noqa: E402


@functools.lru_cache(maxsize=None)
def _case(name):
    (H, hl, R, rl, fl), params = CASES[name]()
    jp = (jax_pairhmm.AlignmentParams.from_list(params) if params
          else jax_pairhmm.AlignmentParams())
    tp = port.AlignmentParams.from_list(params) if params else port.AlignmentParams()
    got = port.pairhmm_scan(*(torch.from_numpy(a) for a in (H, hl, R, rl, fl)),
                            torch.from_numpy(tp.as_array())).numpy()
    return (H, hl, R, rl, fl), jp, tp, got


def _ref_jnp(batch, jp):
    return np.asarray(jax_pairhmm.pairhmm_batch(*batch, jp))


def _ref_pallas_resident(batch, jp):
    return np.asarray(pairhmm_batch_pallas(*batch, jp, interpret=True,
                                           tile_b=8))


def _ref_pallas_chunked(batch, jp):
    # jc=64 streams every case through two or more chunks
    return np.asarray(pairhmm_batch_pallas(*batch, jp, interpret=True,
                                           tile_b=8, jc=64))


def _ref_native(batch, jp):
    out = native.pairhmm_batch_native(*batch, jp.as_array())
    assert out is not None, "native library unavailable"
    return out


REFS = {"jnp_scan": _ref_jnp, "pallas_resident": _ref_pallas_resident,
        "pallas_chunked": _ref_pallas_chunked, "native": _ref_native}


@pytest.mark.parametrize("ref", sorted(REFS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_bit_identical(case, ref):
    batch, jp, _tp, got = _case(case)
    want = REFS[ref](batch, jp)
    assert got.dtype == np.float32
    assert np.array_equal(got, want), (case, ref, got, want)


@pytest.mark.parametrize("case", ["default", "custom_params",
                                  "gates_bandfail", "padded"])
def test_scan_vs_f64_oracle(case):
    (H, hl, R, rl, fl), _jp, tp, got = _case(case)
    want = np.array([
        port.pairhmm_score_oracle(bytes(H[i, :hl[i]]).decode(),
                                  bytes(R[i, :rl[i]]).decode(), tp,
                                  full_hap_len=int(fl[i]))
        for i in range(len(H))])
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_scan_outcomes_cover_the_gates():
    """The cases reach every kind of score: both gates, band fails, and
    ordinary alignments."""
    scores = np.concatenate([_case(c)[3] for c in CASES])
    assert (scores == port.IMPOSSIBLE).any()
    assert (scores == port.BAND_FAIL_SCORE).any()
    assert ((scores > port.BAND_FAIL_SCORE) & (scores < 0)).sum() >= 10
    skew = _case("length_skew")[3]
    assert (skew > port.BAND_FAIL_SCORE).any()


def test_batch_auto_cpu_and_ref_fidelity():
    """pairhmm_batch_auto: the plain scan on the CPU, the native f64 DP
    under --ref-fidelity (bit-identical to the f64 oracle)."""
    from longtr_tpu.utils import mathops as jax_mathops
    from longtr_tpu_torch.utils import mathops
    batch, jp, tp, got = _case("default")
    out = port.pairhmm_batch_auto(*batch, tp, device=torch.device("cpu"))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert np.array_equal(out.numpy(), got)
    # each package keeps its own flag: set both, reset both
    mathops.set_ref_fidelity(True)
    jax_mathops.set_ref_fidelity(True)
    try:
        f64 = port.pairhmm_batch_auto(*batch, tp, device=torch.device("cpu"))
        jax_f64 = np.asarray(jax_pairhmm.pairhmm_batch_auto(*batch, jp))
    finally:
        mathops.set_ref_fidelity(False)
        jax_mathops.set_ref_fidelity(False)
    assert f64.dtype == np.float64
    assert np.array_equal(f64, jax_f64)


def test_batch_auto_rejects_lengths_beyond_width():
    (H, hl, R, rl, fl), _jp, tp, _got = _case("default")
    bad = rl.copy()
    bad[0] = R.shape[1] + 1
    with pytest.raises(ValueError, match="within the padded widths"):
        port.pairhmm_batch_auto(H, hl, R, bad, fl, tp)


def test_params_round_trip():
    """longtr_tpu's AlignmentParams.as_array() loads into PairHMM bit for
    bit, through params_from_numpy and through load_state_dict."""
    for vals in (None, CUSTOM, [-1.1, -0.7, -2.3, -0.1, -1e-5, -11.5, -7.25]):
        jp = (jax_pairhmm.AlignmentParams.from_list(vals) if vals
              else jax_pairhmm.AlignmentParams())
        arr = jp.as_array()
        tp = port.params_from_numpy(arr)
        assert tp.as_array().tobytes() == arr.tobytes()
        model = port.PairHMM()
        model.load_state_dict({"trans": torch.from_numpy(arr)})
        assert model.trans.numpy().tobytes() == arr.tobytes()
        assert port.params_from_numpy(model.trans.numpy()) == tp
        assert port.PairHMM(tp).state_dict()["trans"].numpy().tobytes() \
            == arr.tobytes()
    with pytest.raises(ValueError):
        port.params_from_numpy(np.zeros(6, np.float32))


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors each kernel's wrapper runs the plain scan and counts
    no launch; PairHMM.forward routes the same way."""
    batch, _jp, tp, got = _case("padded")
    t = [torch.from_numpy(a) for a in batch]
    trans = torch.from_numpy(tp.as_array())
    pairhmm_cuda.reset_launches()
    for fn in (pairhmm_cuda.pairhmm_resident,
               pairhmm_cuda.pairhmm_resident_warp,
               pairhmm_cuda.pairhmm_resident_block,
               pairhmm_cuda.pairhmm_streamed_cluster,
               pairhmm_cuda.pairhmm_streamed, pairhmm_cuda.pairhmm_batch):
        assert np.array_equal(fn(*t, trans).numpy(), got)
    assert np.array_equal(pairhmm_cuda.pairhmm_streamed_cluster(
        *t, trans, cluster=3).numpy(), got)
    assert np.array_equal(port.PairHMM(tp)(*t).numpy(), got)
    assert pairhmm_cuda.launches == {"pairhmm_resident_warp": 0,
                                     "pairhmm_resident_block": 0,
                                     "pairhmm_streamed_cluster": 0,
                                     "pairhmm_streamed": 0}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Without nvcc the kernels' build raises; nothing falls back to the
    plain scan."""
    from longtr_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert _build._lib is None


def test_wrapper_checks_refuse_bad_tensors():
    """The launch-side checks reject what the kernels do not take (run on
    meta tensors: the checks need no card and no library)."""
    B, N, M = 4, 16, 24
    meta = torch.device("meta")

    def args(**over):
        a = dict(hap=torch.empty((B, N), dtype=torch.uint8, device=meta),
                 hap_len=torch.empty(B, dtype=torch.int32, device=meta),
                 read=torch.empty((B, M), dtype=torch.uint8, device=meta),
                 read_len=torch.empty(B, dtype=torch.int32, device=meta),
                 full_len=torch.empty(B, dtype=torch.int32, device=meta),
                 trans=torch.empty(7, dtype=torch.float32, device=meta))
        a.update(over)
        return a

    for fn in (pairhmm_cuda.pairhmm_resident,
               pairhmm_cuda.pairhmm_resident_warp,
               pairhmm_cuda.pairhmm_resident_block,
               pairhmm_cuda.pairhmm_streamed_cluster,
               pairhmm_cuda.pairhmm_streamed):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(**args())
    with pytest.raises(ValueError, match="CUDA tensors"):
        pairhmm_cuda.pairhmm_streamed_cluster(**args(), cluster=2)
    wide = torch.empty((B, pairhmm_cuda.BLOCK_MAX_WIDTH + 1),
                       dtype=torch.uint8, device=meta)
    with pytest.raises(ValueError, match="exceeds the warp variant"):
        pairhmm_cuda.pairhmm_resident_warp(**args(read=wide))
    with pytest.raises(ValueError, match="exceeds the block variant"):
        pairhmm_cuda.pairhmm_resident_block(**args(read=wide))
    with pytest.raises(ValueError, match="exceeds the block variant"):
        pairhmm_cuda.pairhmm_resident(**args(read=wide))
