"""The port's CUDA pair-HMM kernels against the plain scan and the native
scorer, on a CUDA card.

This file imports no JAX, so it also runs where JAX is not installed, with
the suite's JAX conftest switched off:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

Without a card its tests skip.  It also holds the seeded batches that
tests/test_torch_pairhmm.py feeds to the plain scan and to longtr_tpu's
scorers on the CPU.
"""

import numpy as np
import pytest
import torch

from longtr_tpu import native
from longtr_tpu_torch.ops import pairhmm as port
from longtr_tpu_torch.ops import pairhmm_cuda

BASES = np.array(list("ACGT"))
CUSTOM = [-2.0, -0.3, -1.5, -0.25, -0.0001, -8.0, -9.0]


def _rand(rng, n):
    return "".join(rng.choice(BASES, size=n))


def _mutate(rng, seq, sub=0.02, ind=0.01):
    out = []
    for ch in seq:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            out += [ch, str(rng.choice(BASES))]
        elif r < ind + sub:
            out.append(str(rng.choice(BASES)))
        else:
            out.append(ch)
    return "".join(out) or "A"


def _encode(pairs, N=None, M=None, full_lens=None):
    N = N or max(len(h) for h, _ in pairs)
    M = M or max(len(r) for _, r in pairs)
    H = np.stack([port.encode_seq(h, N) for h, _ in pairs])
    R = np.stack([port.encode_seq(r, M) for _, r in pairs])
    hl = np.array([len(h) for h, _ in pairs], np.int32)
    rl = np.array([len(r) for _, r in pairs], np.int32)
    fl = hl + 60 if full_lens is None else np.asarray(full_lens, np.int32)
    return H, hl, R, rl, fl


def _case_default(params=None):
    rng = np.random.default_rng(101)
    pairs = []
    for _ in range(10):
        hap = _rand(rng, int(rng.integers(8, 40)))
        pairs.append((hap, _mutate(rng, hap)))
    pairs += [("A", "A"), ("ACGTACGTAC", "A"), ("A", "ACGTACG")]
    return _encode(pairs), params


def _case_gates_bandfail():
    rng = np.random.default_rng(102)
    pairs = [(_rand(rng, int(rng.integers(15, 30))), "") for _ in range(6)]
    pairs = [(h, _mutate(rng, h)) for h, _ in pairs]
    pairs[1] = (pairs[1][0], "G" * len(pairs[1][1]))     # band fail
    pairs[4] = (pairs[4][0], _rand(rng, len(pairs[4][0])))  # unrelated read
    H, hl, R, rl, fl = _encode(pairs)
    fl[0] = 60                                           # short-hap gate
    fl[2] = 61                                           # just above it
    return (H, hl, R, rl, fl), None


def _case_length_skew():
    """|n-m| of 250-550 bp: the band term keeps the shifted diagonal alive."""
    rng = np.random.default_rng(103)
    pairs = []
    for k in range(4):
        hap = _rand(rng, 1024 - int(rng.integers(0, 40)))
        skew = int(rng.integers(250, 550)) * (1 if k % 2 else -1)
        cut = len(hap) // 2
        if skew > 0:
            read = hap[:cut] + hap[cut + skew:]
        else:
            read = hap[:cut] + _rand(rng, -skew) + hap[cut:]
        rd = list(read)
        for p in rng.integers(0, len(rd), size=len(rd) // 50):
            rd[p] = str(rng.choice(BASES))
        pairs.append((hap, "".join(rd)))
    return _encode(pairs), None


def _case_padded():
    """Widths bucketed past every length and padded lanes (hl=rl=fl=1), as
    the pipeline hands batches to the scorer."""
    rng = np.random.default_rng(104)
    pairs = []
    for _ in range(5):
        hap = _rand(rng, int(rng.integers(20, 50)))
        pairs.append((hap, _mutate(rng, hap)))
    H, hl, R, rl, fl = _encode(pairs, N=64, M=128)
    pad = 3
    H = np.pad(H, ((0, pad), (0, 0)))
    R = np.pad(R, ((0, pad), (0, 0)))
    hl, rl, fl = (np.pad(a, (0, pad), constant_values=1) for a in (hl, rl, fl))
    return (H, hl, R, rl, fl), None


# name -> () -> ((hap, hap_len, read, read_len, full_len), params or None)
CASES = {
    "default": lambda: _case_default(),
    "custom_params": lambda: _case_default(CUSTOM),
    "gates_bandfail": _case_gates_bandfail,
    "length_skew": _case_length_skew,
    "padded": _case_padded,
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernels_bit_identical(cuda_device, case):
    """Both kernels, at their default and at small thread counts (so short
    pairs span several segments and tiles), equal the plain scan on the CPU
    and the native scorer bit for bit."""
    batch, params = CASES[case]()
    trans = (port.AlignmentParams.from_list(params) if params
             else port.AlignmentParams()).as_array()
    want = port.pairhmm_scan(*(torch.from_numpy(a)
                               for a in (*batch, trans))).numpy()
    nat = native.pairhmm_batch_native(*batch, trans)
    assert nat is not None, "native library unavailable"
    assert np.array_equal(want, nat)
    g = [torch.from_numpy(a).to(cuda_device) for a in (*batch, trans)]
    outs = [pairhmm_cuda.pairhmm_batch(*g), port.pairhmm_scan(*g)]
    for threads in (None, 32, 64):
        outs.append(pairhmm_cuda.pairhmm_resident(*g, threads=threads))
        outs.append(pairhmm_cuda.pairhmm_streamed(*g, threads=threads))
    torch.cuda.synchronize()
    for out in outs:
        assert out.device == cuda_device and out.dtype == torch.float32
        assert np.array_equal(out.cpu().numpy(), want), case


@pytest.mark.gpu
def test_cuda_routing(cuda_device, monkeypatch):
    """pairhmm_batch sends a width that fits the resident kernel's shared
    memory there and a wider one to the streamed kernel."""
    batch, _ = CASES["padded"]()
    trans = port.AlignmentParams().as_array()
    g = [torch.from_numpy(a).to(cuda_device) for a in (*batch, trans)]
    width = batch[2].shape[1]
    assert pairhmm_cuda.resident_fits(width, cuda_device)
    for limit, kernel in ((None, "pairhmm_resident"),
                          (pairhmm_cuda.resident_smem_bytes(width) - 1,
                           "pairhmm_streamed")):
        monkeypatch.setattr(pairhmm_cuda, "resident_limit_bytes", limit)
        pairhmm_cuda.reset_launches()
        out = pairhmm_cuda.pairhmm_batch(*g)
        torch.cuda.synchronize()
        assert pairhmm_cuda.launches == {
            k: int(k == kernel) for k in pairhmm_cuda.launches}
        assert np.array_equal(out.cpu().numpy(),
                              port.pairhmm_scan(*g).cpu().numpy())
