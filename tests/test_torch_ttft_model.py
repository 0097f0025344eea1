"""The port's analytic TTFT model (``serving/ttft.py``) against the
reference's: ``ttft_breakdown`` equal to relative 1e-12 for every reference
``HARDWARE`` entry x every config both packages have x TP 2/4/8 x
uncompressed or PAPER_DEFAULT x the gather, ring and two_phase schemes;
the reference's entries copied as they are; ``_n_row_reductions`` for every
config; ``wire_bits_per_value`` for all 13 element formats at blocks 8-256;
the H100 entry present and finite; ``python -m
repro_torch.launch.ttft_table`` running on the CPU, and ``fit_h100``
inverting the model it fits.
"""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import pytest

from repro.configs import get_config as j_get_config
from repro.core.formats import ELEMENT_FORMATS as J_ELEMENT_FORMATS
from repro.core.formats import MXSpec as JMXSpec
from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
from repro.serving import ttft as jttft
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.formats import ELEMENT_FORMATS, MXSpec
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.launch import ttft_table
from repro_torch.serving import ttft
from tests.test_torch_families import undercount

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKS = (8, 16, 32, 64, 128, 256)


def close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("hw", sorted(jttft.HARDWARE))
def test_ttft_breakdown_equals_reference(hw, arch):
    cfg_t, cfg_j = get_config(arch), j_get_config(arch)
    hw_t, hw_j = ttft.HARDWARE[hw], jttft.HARDWARE[hw]
    assert dataclasses.asdict(hw_t) == dataclasses.asdict(hw_j)
    # the compute term reads the port's active parameter count, which holds
    # what the reference's leaves out of a Mamba layer, a vision prefix, an
    # encoder-decoder and xLSTM layers, and nothing else (0 for the rest;
    # tests/test_torch_families.py::test_param_count_matches_reference)
    gap = cfg_t.active_param_count() - cfg_j.active_param_count()
    assert gap == undercount(cfg_t)
    for tp in (2, 4, 8):
        extra = lambda tokens: 2.0 * gap * tokens / (tp * hw_t.peak_flops * hw_t.mfu)
        for spec_t, spec_j in ((None, None), (PAPER_DEFAULT.spec, J_PAPER_DEFAULT.spec)):
            for scheme in ("gather", "ring", "two_phase"):
                for batch, seq in ((1, 512), (16, 128)):
                    got = ttft.ttft_breakdown(cfg_t, hw_t, tp, batch, seq, spec_t, scheme=scheme)
                    ref = jttft.ttft_breakdown(cfg_j, hw_j, tp, batch, seq, spec_j, scheme=scheme)
                    for k in ("compute", "total"):
                        ref[k] += extra(batch * seq)
                    assert got.keys() == ref.keys()
                    assert all(close(got[k], ref[k]) for k in ref), (tp, spec_t, scheme, got, ref)
                    assert close(ttft.ttft_seconds(cfg_t, hw_t, tp, batch, seq, spec_t, scheme),
                                 ref["total"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_row_reductions_equal_reference(arch):
    """Two a decoder layer, one an xLSTM layer (mLSTM ``down``, sLSTM
    ``ff_down``: xlstm-125m 12); an encoder-decoder adds each decoder
    layer's cross-attention ``wo`` and each encoder layer's two (whisper:
    120)."""
    cfg = get_config(arch)
    n = ttft._n_row_reductions(cfg)
    enc = cfg.n_layers + 2 * cfg.n_encoder_layers if cfg.encoder_decoder else 0
    per_layer = sum(1 if sp.kind in ("mlstm", "slstm") else 2 for sp in cfg.layers)
    assert n == jttft._n_row_reductions(j_get_config(arch)) == per_layer + enc
    assert arch != "whisper-medium" or n == 120
    assert arch != "xlstm-125m" or n == 12


@pytest.mark.parametrize("hw", sorted(jttft.HARDWARE))
def test_whisper_encoder_sized_at_decoder_tokens_like_reference(hw):
    """Both TTFT models size whisper's 48 encoder reductions (and all the
    compute) at the decoder's ``batch * seq`` tokens, not at its 1500
    encoder frames: at 64 tokens about 23x too few encoder bytes (ROADMAP
    Queue 3 item 15). The port keeps the reference's model, so its
    breakdown equals the reference's (the compute term plus the parameters
    the reference's count leaves out, as above)."""
    cfg_t, cfg_j = get_config("whisper-medium"), j_get_config("whisper-medium")
    hw_t, hw_j = ttft.HARDWARE[hw], jttft.HARDWARE[hw]
    gap = cfg_t.active_param_count() - cfg_j.active_param_count()
    tp, batch, seq = 2, 1, 64
    got = ttft.ttft_breakdown(cfg_t, hw_t, tp, batch, seq, PAPER_DEFAULT.spec)
    ref = jttft.ttft_breakdown(cfg_j, hw_j, tp, batch, seq, J_PAPER_DEFAULT.spec)
    extra = 2.0 * gap * batch * seq / (tp * hw_t.peak_flops * hw_t.mfu)
    for k in ("compute", "total"):
        ref[k] += extra
    assert got.keys() == ref.keys() and all(close(got[k], ref[k]) for k in ref)
    # every one of the 120 reductions moves the wire bytes of 64 decoder
    # tokens, the encoder's 48 included
    bits = PAPER_DEFAULT.spec.wire_bits_per_value(cfg_t.d_model)
    per_red = (tp - 1) * batch * seq * cfg_t.d_model * bits / 8
    assert close(got["comm"], ttft._n_row_reductions(cfg_t) * per_red / hw_t.link_bw)
    assert ttft._n_row_reductions(cfg_t) - ttft._n_row_reductions(
        dataclasses.replace(cfg_t, encoder_decoder=False)) == 72
    assert 23 < cfg_t.encoder_seq / (batch * seq) < 24


@pytest.mark.parametrize("elem", sorted(J_ELEMENT_FORMATS))
def test_wire_bits_per_value_equals_reference(elem):
    assert sorted(ELEMENT_FORMATS) == sorted(J_ELEMENT_FORMATS)
    for block in BLOCKS:
        spec_t, spec_j = MXSpec.make(elem, block, "e8m0"), JMXSpec.make(elem, block, "e8m0")
        for n in (block, 4 * block, 4096, 5120):
            if n % block == 0:
                assert spec_t.wire_bits_per_value(n) == spec_j.wire_bits_per_value(n)


def test_h100_entry_present_and_finite():
    hw = ttft.HARDWARE["H100"]
    fields = dataclasses.asdict(hw)
    assert hw.name == "H100" and hw.peak_flops == 989e12 and hw.hbm_bw == 3.35e12
    assert all(math.isfinite(v) and v > 0 for k, v in fields.items() if k != "name")
    assert 0 < hw.mfu <= 1
    b = ttft.ttft_breakdown(get_config("llama2-70b"), hw, 8, 2, 128, PAPER_DEFAULT.spec)
    assert all(math.isfinite(v) and v > 0 for v in b.values())


def test_fit_h100_inverts_the_model():
    """``fit_h100`` on the times the H100 entry itself predicts gives back
    its constants: mfu from a one-card prefill at 2048 tokens, codec_passes
    from one reduction's codec time at 512 tokens, TP 4."""
    hw, cfg = ttft.HARDWARE["H100"], get_config("llama2-7b")
    compute = ttft.ttft_breakdown(cfg, hw, 1, 1, 2048)["compute"]
    codec = ttft.ttft_breakdown(cfg, hw, 4, 1, 512, PAPER_DEFAULT.spec)["codec"]
    per_red = codec / ttft._n_row_reductions(cfg)
    fit = ttft_table.fit_h100(compute, hw.codec_fixed_s / 2, per_red / 2, per_red / 2)
    assert math.isclose(fit["mfu"], hw.mfu, rel_tol=1e-12)
    assert math.isclose(fit["codec_fixed_s"], hw.codec_fixed_s, rel_tol=1e-12)
    assert math.isclose(fit["codec_passes"], hw.codec_passes, rel_tol=1e-9)


def test_ttft_table_runs_on_the_cpu(tmp_path):
    record = tmp_path / "chip_smoke.json"
    ttft_ms = {"compressed/512": 31.0, "uncompressed/512": 29.5,
               "compressed/2048": 110.0, "uncompressed/2048": 105.0}
    record.write_text('{"serve": {"ttft": {%s}}}' % ", ".join(
        f'"{k}": {{"median_s": {v / 1e3}}}' for k, v in ttft_ms.items()))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for extra in ([], ["--measured", str(record)]):
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.ttft_table", *extra],
                             capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
        assert res.returncode == 0, res.stderr
        lines = res.stdout.splitlines()
        assert lines[0].startswith("# Table 3 on the analytic model, H100")
        assert sum(ln.startswith("llama2-") for ln in lines) == len(ttft_table.PAPER_ROWS)
        check = [ln for ln in lines if ln.startswith("one card")]
        assert len(check) == 2
        assert ("not measured" in check[0]) == (not extra)
    assert "1.500 ms (31.000 - 29.500)" in check[0]
