"""The codec kernels' CUDA sources, compiled for the CPU, against the plain
versions.

``csrc/mx_quant.cu``, ``mx_dequant.cu`` and ``mx_dequant_reduce.cu`` (with
``mx_common.cuh``) are compiled by g++ against ``tests/cuda_cpu/cuda_shim.h``,
which runs a launch's CTAs in turn and each thread of a CTA on a
``std::thread``; every ``kernel<<<grid, block, ...>>>(args)`` is rewritten to
the shim's call. The C launchers are then called through ctypes with the
signatures the build binds (``kernels/build._SIGNATURES``) on CPU tensors:
``chip_smoke.py``'s codec inputs at a reduced size (fp32 rows with full
mantissas and the edge rows included), with the bytes held exactly against
the plain versions. This checks the kernels' own code (templates, packing,
the code search, the grid-stride loops and the shuffles of a split block)
without a card; it does not check the nvcc build or the speed. Skipped
where g++ is missing.
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.core.formats import ELEMENT_FORMATS, MXSpec
from repro_torch.core.mx import MXCompressed, code_tables
from repro_torch.kernels import mx_dequant, mx_quant
from repro_torch.kernels.build import _SIGNATURES

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SHIM = ROOT / "tests" / "cuda_cpu"
SOURCES = ("mx_quant.cu", "mx_dequant.cu", "mx_dequant_reduce.cu")
LAUNCH = re.compile(r"(mx_\w+_kernel<[^>]*>)<<<([^,]+),\s*([^,>]+)(?:,[^>]*)?>>>\(")
TP, T, WIDTH = 4, 65, 512    # 4 * 65 rows hold the ragged 257 rows from row 3

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

SPECS = [MXSpec.make(f, 32, "e8m0") for f in sorted(ELEMENT_FORMATS)]
SPECS += [MXSpec.make(f, b, "e8m0") for f in ("fp4_e2m1", "int8") for b in chip_smoke.CODEC_BLOCKS]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the kernel sources cannot be compiled for the CPU")
    out = tmp_path_factory.mktemp("codec_source")
    procs = []
    for name in SOURCES:
        text, n = LAUNCH.subn(r"shim_launch(\2, \3, \1, ", (CSRC / name).read_text())
        assert n and "<<<" not in text, name
        src = out / name.replace(".cu", ".cpp")
        src.write_text(text)
        procs.append(subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-fPIC", "-I", str(SHIM), "-I", str(CSRC),
             "-include", "cuda_shim.h", "-c", str(src), "-o", str(src.with_suffix(".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text, _ = p.communicate()
        assert p.returncode == 0, text
    so = out / "libcodec_cpu.so"
    subprocess.run([gxx, "-shared", "-o", str(so), *map(str, sorted(out.glob("*.o"))),
                    "-lpthread"], check=True)
    cdll = ctypes.CDLL(str(so))
    for fn in ("mxk_quant", "mxk_dequant", "mxk_dequant_reduce"):
        getattr(cdll, fn).argtypes = _SIGNATURES[fn]
        getattr(cdll, fn).restype = ctypes.c_int
    return cdll


def _quant(lib, x, spec):
    m, n = x.shape
    payload = torch.full((m, n * spec.elem.bits // 8), 0xAB, dtype=torch.uint8)
    scales = torch.full((m, n // spec.block_size), 0xCD, dtype=torch.uint8)
    mids, _ = code_tables(spec, x.device)
    err = lib.mxk_quant(x.data_ptr(), int(x.dtype == torch.bfloat16), payload.data_ptr(),
                        scales.data_ptr(), mids.data_ptr(), len(spec.elem.midpoints),
                        spec.elem.zero_code, m * n // 8, spec.block_size // 8, spec.elem.bits,
                        spec.elem.emax, spec.scale.min_exp, spec.scale.max_exp, spec.scale.bias,
                        None)
    assert err == 0
    return MXCompressed(payload, scales)


def _dequant(lib, c, spec, dt):
    m, n = c.payload.shape[0], c.scales.shape[1] * spec.block_size
    out = torch.empty((m, n), dtype=dt)
    _, vals = code_tables(spec, c.payload.device)
    err = lib.mxk_dequant(c.payload.data_ptr(), c.scales.data_ptr(), out.data_ptr(),
                          int(dt == torch.bfloat16), vals.data_ptr(), spec.elem.num_codes,
                          m * n // 8, spec.block_size // 8, spec.elem.bits, spec.scale.bias, None)
    assert err == 0
    return out


def _dequant_reduce(lib, c, spec, dt):
    s, m = c.payload.shape[:2]
    n = c.scales.shape[-1] * spec.block_size
    out = torch.empty((m, n), dtype=dt)
    _, vals = code_tables(spec, c.payload.device)
    err = lib.mxk_dequant_reduce(c.payload.data_ptr(), c.scales.data_ptr(), out.data_ptr(),
                                 int(dt == torch.bfloat16), vals.data_ptr(), spec.elem.num_codes,
                                 m * n // 8, s, spec.block_size // 8, spec.elem.bits,
                                 spec.scale.bias, None)
    assert err == 0
    return out


def _same(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _inputs(spec):
    g = torch.Generator().manual_seed(0)
    x, xf = chip_smoke.codec_partials(torch, TP * T, WIDTH, g, "cpu")
    return chip_smoke.codec_inputs(torch, x, xf, spec, T)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_quant_and_dequant_sources_match_plain(lib, spec):
    """Quantize bytes equal the plain version's on every input; dequantizing
    each result to bf16 and fp32 equals the plain version (NaN where NaN)."""
    inputs = _inputs(spec)
    assert inputs[2].dtype == torch.float32
    assert not torch.equal(inputs[2], inputs[2].to(torch.bfloat16).float())
    for x in inputs:
        k, p = _quant(lib, x, spec), mx_quant.quantize_plain(x, spec)
        what = f"{spec.name} {x.dtype} {tuple(x.shape)}"
        assert torch.equal(k.scales, p.scales), what
        assert torch.equal(k.payload, p.payload), what
        for dt in (torch.bfloat16, torch.float32):
            assert _same(_dequant(lib, p, spec, dt), mx_dequant.dequantize_plain(p, spec, dt)), \
                f"{what} -> {dt}"


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_dequant_reduce_source_matches_plain(lib, spec):
    """The TP partials' wire bytes, split into TP shards, dequantized and
    summed in shard order: equal to the plain version in bf16 and fp32."""
    x = _inputs(spec)[0]
    c = mx_quant.quantize_plain(x, spec)
    w = MXCompressed(c.payload.reshape(TP, T, -1), c.scales.reshape(TP, T, -1))
    for dt in (torch.bfloat16, torch.float32):
        assert _same(_dequant_reduce(lib, w, spec, dt),
                     mx_dequant.dequant_reduce_plain(w, spec, dt)), dt


def test_shim_rewrites_every_launch():
    """Every launch in the codec sources has the form the rewrite takes (one
    per width, element type and chunk size), so none is left uncompiled."""
    counts = {name: len(LAUNCH.findall((CSRC / name).read_text())) for name in SOURCES}
    assert counts == {"mx_quant.cu": 3, "mx_dequant.cu": 8, "mx_dequant_reduce.cu": 8}
    for name in SOURCES:
        assert (CSRC / name).read_text().count("<<<") == counts[name]
