"""The bf16 GEMM and flash backward on the tensor cores
(csrc/matmul_bf16.cu, csrc/flash_attention_bwd_bf16.cu, both over
csrc/hopper.cuh).

The CPU tests check how the two libraries are built and what their
sources hold.  The ``gpu``-marked tests hold each kernel against its
plain PyTorch version on the card, and skip here; on the card run them
with

    python -m pytest -m gpu tests/test_torch_bf16_tc.py

This file imports no JAX: the plain versions are the reference on the
card (they are held against the Pallas kernels in ``test_torch_bf16.py``).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from parsec_tpu_torch.ops import kernels
from test_torch_flash_tc import CARD_CASES

BF16 = torch.bfloat16
#: a kernel against its plain version, relative max error: both round
#: once to bf16 but sum in other orders, and the backward's tensor-core
#: products take P and dS rounded to bf16 where the plain version keeps
#: them in fp32
BF16_RTOL = 1e-2
CSRC = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc"
NEW = {"matmul_bf16": "matmul_bf16", "flash_attention_bwd_bf16":
       "flash_attention_bwd_bf16"}
FP32_SOURCES = ("matmul", "flash_attention", "flash_attention_bwd")


def _code(path: pathlib.Path) -> str:
    """A source's text without its comments."""
    return re.sub(r"//[^\n]*", "", path.read_text())


def _with_header(source: str) -> str:
    """A tensor-core source's code and that of the shared header."""
    return _code(CSRC / f"{source}.cu") + _code(CSRC / "hopper.cuh")


def test_bf16_gemm_and_backward_build_from_their_own_sources():
    """The two bf16 libraries are their tensor-core sources built as they
    are: no library of the table is built with -DPTT_BF16, and the table
    keeps its seven libraries beside the two wide-head ones (128 < D <=
    256, both types in each)."""
    assert len(kernels._LIBRARIES) == 9
    assert sorted(n for n, (_s, tag, _f) in kernels._LIBRARIES.items()
                  if tag is None) == ["flash_attention_bwd_wide",
                                      "flash_attention_wide"]
    for name, source in NEW.items():
        assert kernels._LIBRARIES[name] == (source, "bf16", ())
        cmd = kernels._nvcc_command(name)
        assert cmd[-1] == str(CSRC / f"{source}.cu")
        assert "-DPTT_BF16" not in cmd
    assert all("-DPTT_BF16" not in flags
               for _src, _tag, flags in kernels._LIBRARIES.values())
    for name in FP32_SOURCES:
        assert kernels._LIBRARIES[name] == (name, "f32", ())


@pytest.mark.parametrize("source", sorted(NEW.values()))
def test_bf16_source_runs_on_the_tensor_cores(source):
    """Products are wgmma instructions with both operands from shared
    memory, fed by TMA over tensor maps; the backward also takes A from
    registers (the register-A form: P and dS reach dV and dK without
    touching shared memory) and reads MN-major operands through the
    transpose bits."""
    code = _with_header(source)
    assert '#include "hopper.cuh"' in (CSRC / f"{source}.cu").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in code
    assert "cp.async.bulk.tensor.3d" in code
    assert "cuTensorMapEncodeTiled" in code
    own = _code(CSRC / f"{source}.cu")
    assert "tma_load_3d(" in own and "setmaxnreg" in own
    if source == "flash_attention_bwd_bf16":
        # A (4 registers of bf16 pairs), B transposed
        assert "{%32, %33, %34, %35}, %36, p, 1, 1, 1;" in code
        assert "wgmma_rs_n64(" in own
        assert "wgmma_ss_n64<1, 1>(" in own      # dQ = dS K, both MN-major
        assert "wgmma_ss_n64<0, 0>(" in own      # S^T and dP^T, K-major
    else:
        assert "wgmma_ss_n64<0, 1>(" in own      # nn: B MN-major
        assert "wgmma_ss_n64<0, 0>(" in own      # nt: B K-major


@pytest.mark.parametrize("source", sorted(NEW.values()))
def test_bf16_source_has_no_float_atomics(source):
    """No atomic on a float anywhere: no PTX red. or atom. at all, and
    the only atomicAdd is the backward's integer work counter."""
    code = _with_header(source)
    assert not re.search(r"\bred\.|\batom\.", code)
    adds = re.findall(r"atomicAdd\(([^,]*),", code)
    assert adds == (["work"] if source == "flash_attention_bwd_bf16"
                    else [])
    assert re.search(r"int\* work = a\.counters", code) or not adds


def test_fp32_sources_hold_no_bf16_entry_point():
    """After the move the fp32 sources carry no bf16 build: no PTT_BF16
    branch, no bf16 entry point, no bf16 type."""
    for name in FP32_SOURCES:
        code = _code(CSRC / f"{name}.cu")
        assert "PTT_BF16" not in code
        assert "__nv_bfloat16" not in code and "cuda_bf16.h" not in code
        assert not re.search(r"\bptt_\w*bf16\b", code)
        assert "is_bf16" not in code


def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    """A library's build is keyed on the headers of csrc/ its source
    includes: an edit to hopper.cuh builds the tensor-core libraries (the
    forward's measurement build too) anew and no other."""
    for f in CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "_CSRC", tmp_path)
    before = {n: kernels._library_path(n) for n in kernels._LIBRARIES}
    assert kernels._headers("matmul_bf16") == ["hopper.cuh"]
    assert kernels._headers("matmul") == []
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {n: kernels._library_path(n) for n in kernels._LIBRARIES}
    changed = {n for n in before if before[n] != after[n]}
    assert changed == set(NEW) | {"flash_attention_bf16",
                                  "flash_attention_bf16_phases"}


def test_backward_counters_match_the_bf16_query_tile():
    """The wrapper sizes the turn counters for FLASH_BWD_BQ-row query
    tiles; the bf16 backward's own query tile must be that size, and its
    C entry refuses a scratch too small for it."""
    code = _code(CSRC / "flash_attention_bwd_bf16.cu")
    assert re.search(rf"constexpr int BQ = {kernels.FLASH_BWD_BQ};", code)
    assert "n_counters < static_cast<long long>(bh) * ((T + BQ - 1) / BQ) + 1" \
        in code
    assert kernels._flash_bwd_counters(6, 130, "cpu").numel() == 6 * 3 + 1


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _rand(dev, *shape, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev,
                                                                    BF16)


def _rel(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """The same values one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


BWD_CASES = CARD_CASES + [(8, 12, 1024, 1024, 64, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=["x".join(map(str, c[:5])) + ("_causal" if c[5]
                                                           else "")
                              for c in BWD_CASES])
def test_bf16_backward_matches_plain_on_card(cuda_device, case):
    """dq, dk and dv within BF16_RTOL of the plain version, one launch on
    the bf16 backward's counter a call, three launches bit-equal."""
    B, H, T, Tk, D, causal = case
    q = _rand(cuda_device, B, H, T, D, seed=1)
    k = _rand(cuda_device, B, H, Tk, D, seed=2)
    v = _rand(cuda_device, B, H, Tk, D, seed=3)
    do = _rand(cuda_device, B, H, T, D, seed=4)
    o, m, l = kernels.flash_attention_stats(q, k, v, causal=causal)
    before = (kernels.flash_bwd_launches, kernels.flash_bwd_bf16_launches)
    got = kernels.flash_attention_bwd(q, k, v, o, m, l, do, causal)
    torch.cuda.synchronize()
    assert (kernels.flash_bwd_launches - before[0],
            kernels.flash_bwd_bf16_launches - before[1]) == (0, 1)
    ref = kernels.flash_attention_bwd_plain(q, k, v, o, m, l, do, causal)
    for a, b in zip(got, ref):
        assert a.dtype == BF16
        assert _rel(a, b) < BF16_RTOL
    for _ in range(2):
        again = kernels.flash_attention_bwd(q, k, v, o, m, l, do, causal)
        assert all(map(torch.equal, got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 40, 128])
def test_bf16_backward_misaligned_equals_aligned_on_card(cuda_device, D):
    """Operands one element past a 16-byte boundary take the loader's
    per-thread copy into the same swizzled layout: the same bits."""
    q, k, v, do = (_rand(cuda_device, 2, 4, 1000, D, seed=s)
                   for s in range(4))
    o, m, l = kernels.flash_attention_stats(q, k, v, causal=True)
    unaligned = [_misaligned(x) for x in (q, k, v, o, m, l, do)]
    aligned = [x.clone() for x in unaligned]
    assert all(x.data_ptr() % 16 != 0 for x in unaligned)
    assert all(map(torch.equal, kernels.flash_attention_bwd(*unaligned),
                   kernels.flash_attention_bwd(*aligned)))


GEMM_CASES = [((1024, 1024), (1024, 1024), False),
              ((1024, 1024), (1024, 1024), True),
              ((999, 997), (997, 1001), False),
              ((999, 997), (1001, 997), True),
              ((3, 999, 997), (3, 1001, 997), True),
              ((2, 256, 512), (2, 512, 384), False)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GEMM_CASES,
                         ids=["x".join(map(str, a)) + ("_nt" if t else "_nn")
                              for a, _b, t in GEMM_CASES])
def test_bf16_gemm_matches_plain_on_card(cuda_device, case):
    """A . op(B) within BF16_RTOL of the plain version, in bf16, one
    launch on the bf16 GEMM's counter, repeats bit-equal."""
    sa, sb, trans_b = case
    a, b = _rand(cuda_device, *sa, seed=5), _rand(cuda_device, *sb, seed=6)
    before = (kernels.matmul_launches, kernels.matmul_bf16_launches)
    out = kernels.gemm(a, b, trans_b=trans_b)
    torch.cuda.synchronize()
    assert (kernels.matmul_launches - before[0],
            kernels.matmul_bf16_launches - before[1]) == (0, 1)
    assert out.dtype == BF16
    assert _rel(out, kernels.gemm_plain(a, b, trans_b=trans_b)) < BF16_RTOL
    assert torch.equal(out, kernels.gemm(a, b, trans_b=trans_b))


Z3_CASES = [((3, 999, 997), (3, 1001, 997), True),
            ((3, 1024, 1024), (3, 1024, 1024), False),
            ((3, 1024, 1024), (3, 1024, 1024), True)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", Z3_CASES,
                         ids=["x".join(map(str, a)) + ("_nt" if t else "_nn")
                              for a, _b, t in Z3_CASES])
def test_bf16_gemm_batch_is_bit_exact_on_card(cuda_device, case):
    """A z = 3 launch gives each slice the bits of its own launch: with
    odd strides (the per-thread copy) and with 16-byte aligned ones (TMA
    over the 3-D tensor maps)."""
    sa, sb, trans_b = case
    a3, b3 = _rand(cuda_device, *sa, seed=7), _rand(cuda_device, *sb, seed=8)
    batched = kernels.gemm(a3, b3, trans_b=trans_b)
    assert _rel(batched, kernels.gemm_plain(a3, b3, trans_b=trans_b)) \
        < BF16_RTOL
    for i in range(3):
        assert torch.equal(batched[i], kernels.gemm(a3[i], b3[i],
                                                    trans_b=trans_b))


@pytest.mark.gpu
def test_bf16_gemm_alignment_is_bit_exact_on_card(cuda_device):
    """The per-thread copy of misaligned operands gives the bits of
    TMA's."""
    ua = _misaligned(_rand(cuda_device, 1024, 1024, seed=9))
    ub = _misaligned(_rand(cuda_device, 1024, 1024, seed=10))
    for trans_b in (False, True):
        assert torch.equal(kernels.gemm(ua, ub, trans_b=trans_b),
                           kernels.gemm(ua.clone(), ub.clone(),
                                        trans_b=trans_b))
