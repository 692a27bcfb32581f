"""The bf16 flash forward's tensor-core kernel (csrc/flash_attention_bf16.cu).

The ``gpu``-marked tests hold both of its entry points (the plain
forward and the STATS form) against their plain PyTorch version on the
card, and skip here; on the card run them with

    python -m pytest -m gpu tests/test_torch_flash_tc.py

The others check on the CPU how the bf16 forward is built.  This file
imports no JAX: the plain version is the reference on the card (the
plain version itself is held against the Pallas kernel in
``test_torch_bf16.py``).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from parsec_tpu_torch.ops import kernels

BF16 = torch.bfloat16
#: o against the plain version: both round once to bf16 but sum in other
#: orders, and p is rounded at the running max of another key tile
BF16_RTOL = 1e-2
#: m and l (fp32) against the plain version
STATS_RTOL = 1e-4
CSRC = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc"
COUNTERS = ("flash_launches", "flash_stats_launches", "flash_bf16_launches",
            "flash_stats_bf16_launches")

#: (B, H, T, Tk, D, causal): the bf16 flash kernels' card cases (also
#: test_torch_bf16.py's): square and ragged, T above and below Tk, D not
#: a multiple of 8, D = 128
CARD_CASES = [(2, 3, 256, 256, 64, True), (2, 3, 256, 256, 64, False),
              (1, 2, 1000, 1000, 40, True), (1, 2, 300, 300, 33, True),
              (1, 2, 1000, 1500, 64, True), (1, 2, 1000, 300, 64, True),
              (1, 1, 70, 130, 128, False)]
#: the forward's: those, D = 128 at T = 1000, a tile smaller than every
#: block, and the forward's shape
CASES = CARD_CASES + [(1, 2, 1000, 1000, 128, True), (1, 1, 5, 7, 16, True),
                      (8, 12, 1024, 1024, 64, True)]


def _code(path: pathlib.Path) -> str:
    """A source's text without its comments."""
    return re.sub(r"//[^\n]*", "", path.read_text())


def test_bf16_flash_forward_builds_from_its_own_source():
    """The bf16 flash library is the tensor-core source built as it is;
    so are the GEMM's and the backward's bf16 libraries, each from its
    own tensor-core source."""
    assert kernels._LIBRARIES["flash_attention_bf16"] == (
        "flash_attention_bf16", "bf16", ())
    assert kernels._LIBRARIES["flash_attention"] == (
        "flash_attention", "f32", ())
    cmd = kernels._nvcc_command("flash_attention_bf16")
    assert cmd[-1] == str(CSRC / "flash_attention_bf16.cu")
    assert "-DPTT_BF16" not in cmd
    for name in ("matmul", "flash_attention_bwd"):
        assert kernels._LIBRARIES[f"{name}_bf16"] == (f"{name}_bf16", "bf16",
                                                      ())
    assert kernels._LIBRARIES["flash_attention_bf16_phases"] == (
        "flash_attention_bf16", "bf16", ("-DPTT_PHASE_CLOCKS",))
    assert (kernels._library_path("flash_attention_bf16_phases")
            != kernels._library_path("flash_attention_bf16"))


def test_bf16_flash_forward_clocks_only_in_its_measurement_build():
    """The phase clocks are compiled only with -DPTT_PHASE_CLOCKS: outside
    that block their macros expand to nothing, so the plain build's code
    reads no clock and writes no sums."""
    code = _code(CSRC / "flash_attention_bf16.cu")
    plain = re.sub(r"#ifdef PTT_PHASE_CLOCKS.*?#(else|endif)", "", code,
                   flags=re.S)
    assert "clock64" in code and "g_phase" in code
    assert "clock64" not in plain and "g_phase" not in plain
    for macro in ("PHASE_START", "PHASE(i)", "PHASE_COUNT(i)",
                  "PHASE_STORE(row)"):
        assert re.search(rf"#define {re.escape(macro)}\n", plain)


def test_bf16_flash_forward_source_runs_on_the_tensor_cores():
    """Its products are wgmma instructions fed by TMA, P reaches P.V from
    registers (the register-A form), and it has no atomics; the fp32
    source no longer carries bf16 entry points.  The forms it shares with
    the other tensor-core sources live in their header, csrc/hopper.cuh."""
    own = _code(CSRC / "flash_attention_bf16.cu")
    assert '#include "hopper.cuh"' in (CSRC / "flash_attention_bf16.cu"
                                       ).read_text()
    assert "tma_load_3d(" in own and "wgmma_rs_n64(" in own
    code = own + _code(CSRC / "hopper.cuh")
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in code
    assert "cp.async.bulk.tensor.3d" in code
    # P . V in the register-A form: A is 4 registers of bf16 pairs, B the
    # V tile read through the transpose bit
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in code
    assert "{%32, %33, %34, %35}, %36, p, 1, 1, 1;" in code
    # no atomicAdd and the like, no PTX atom. or red.
    assert not re.search(r"\batomic|\batom\.|\bred\.", code)
    for entry in ("ptt_flash_fwd_bf16", "ptt_flash_fwd_stats_bf16",
                  "ptt_flash_fwd_bf16_attributes"):
        assert f"int {entry}(" in code
    fp32 = _code(CSRC / "flash_attention.cu")
    assert "ptt_flash_fwd_bf16" not in fp32 and "PTT_BF16" not in fp32


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _qkv(dev, B, H, T, Tk, D, seed=7):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, H, t, D).astype(np.float32))
                 .to(dev, BF16) for t in (T, Tk, Tk))


def _rel(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """The same values one element (2 bytes) past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def _counts() -> dict:
    return {n: getattr(kernels, n) for n in COUNTERS}


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES,
                         ids=["x".join(map(str, c[:5])) + ("_causal" if c[5]
                                                           else "")
                              for c in CASES])
def test_bf16_flash_forward_matches_plain_on_card(cuda_device, case):
    """Both entry points against the plain version (o within BF16_RTOL, m
    and l within STATS_RTOL), each counted on its bf16 counter; the two
    give the same o; three launches of each give the same bits."""
    *shape, causal = case
    q, k, v = _qkv(cuda_device, *shape)
    before = _counts()
    o = kernels.flash_attention(q, k, v, causal=causal)
    so, m, l = kernels.flash_attention_stats(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = _counts()
    assert {n: after[n] - before[n] for n in COUNTERS} == {
        "flash_launches": 0, "flash_stats_launches": 0,
        "flash_bf16_launches": 1, "flash_stats_bf16_launches": 1}
    ro, rm, rl = kernels.flash_attention_stats_plain(q, k, v, causal=causal)
    assert o.dtype == so.dtype == BF16
    assert m.dtype == l.dtype == torch.float32
    assert _rel(o, ro) < BF16_RTOL
    assert _rel(m, rm) < STATS_RTOL and _rel(l, rl) < STATS_RTOL
    assert torch.equal(o, so)
    for _ in range(2):
        assert torch.equal(kernels.flash_attention(q, k, v, causal=causal),
                           o)
        again = kernels.flash_attention_stats(q, k, v, causal=causal)
        assert all(map(torch.equal, again, (so, m, l)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(1, 2, 1000, 1000, 64, True),
                                  (1, 2, 300, 300, 40, True),
                                  (1, 1, 70, 130, 128, False)])
def test_bf16_flash_forward_misaligned_equals_aligned_on_card(cuda_device,
                                                              case):
    """Operands 2 bytes past a 16-byte boundary take the per-thread copy
    instead of TMA, into the same shared-memory layout: the same bits."""
    *shape, causal = case
    aligned = _qkv(cuda_device, *shape)
    unaligned = tuple(map(_misaligned, aligned))
    assert all(x.data_ptr() % 16 == 2 for x in unaligned)
    assert torch.equal(kernels.flash_attention(*unaligned, causal=causal),
                       kernels.flash_attention(*aligned, causal=causal))
    assert all(map(torch.equal,
                   kernels.flash_attention_stats(*unaligned, causal=causal),
                   kernels.flash_attention_stats(*aligned, causal=causal)))


@pytest.mark.gpu
def test_bf16_flash_stats_merge_rule_on_card(cuda_device):
    """Two key sets merged by their m and l give attention over both."""
    q, k1, v1 = _qkv(cuda_device, 2, 4, 256, 384, 64, seed=3)
    _q, k2, v2 = _qkv(cuda_device, 2, 4, 256, 200, 64, seed=4)
    o1, m1, l1 = kernels.flash_attention_stats(q, k1, v1)
    o2, m2, l2 = kernels.flash_attention_stats(q, k2, v2)
    m = torch.maximum(m1, m2)
    w1, w2 = torch.exp(m1 - m) * l1, torch.exp(m2 - m) * l2
    merged = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / (
        w1 + w2)[..., None]
    ref = kernels.flash_attention_plain(q, torch.cat([k1, k2], 2),
                                        torch.cat([v1, v2], 2), causal=False)
    assert _rel(merged, ref) < BF16_RTOL
