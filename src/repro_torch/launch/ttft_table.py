"""The paper's Table 3 on the analytic TTFT model's H100 entry.

    PYTHONPATH=src python -m repro_torch.launch.ttft_table
    PYTHONPATH=src python -m repro_torch.launch.ttft_table --measured chiprun_out/chip_smoke.json

Prints the predicted TTFT of llama2-7b, 13b and 70b at TP 2, 4 and 8 on the
``H100`` entry of ``serving/ttft.HARDWARE``, uncompressed and compressed
(``PAPER_DEFAULT``: MX fp4_e2m1, block 32, e8m0 scales), at each batch x
sequence of the paper's Table 3 rows, beside the paper's measured row (8x L4
or 4x A100). Then the one-card check: the model's codec term at TP 4 (what
``simulate_tp=4`` runs on one card: four quantized partials of the whole
tensor, then one fused dequantize-and-sum) against the measured graphed
compressed minus uncompressed ``measure_ttft`` of llama2-7b at 512 and 2048
tokens, read from ``chip_smoke.py``'s record (``--measured``; without it the
measured column says "not measured"). It is analytic, so it runs on the CPU.

``fit_h100`` gives the H100 entry's fitted constants from the card's
numbers; ``chip_smoke.py`` prints it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, Optional, Tuple

from repro_torch.configs import get_config
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.serving.ttft import HARDWARE, ttft_breakdown

__all__ = ["PAPER_ROWS", "fit_h100", "table", "one_card_check", "main"]

# the paper's Table 3: (model, hardware, tp, batch, seq, uncompressed s,
# compressed s), the port's own copy
PAPER_ROWS = [
    ("llama2-70b", "L4", 8, 2, 64, 0.58, 0.32),
    ("llama2-70b", "L4", 8, 2, 128, 1.07, 0.52),
    ("llama2-70b", "A100", 4, 2, 128, 0.09, 0.15),
    ("llama2-70b", "A100", 4, 2, 256, 0.13, 0.19),
    ("llama2-13b", "L4", 4, 8, 128, 0.67, 0.33),
    ("llama2-13b", "L4", 4, 8, 256, 1.37, 0.70),
    ("llama2-7b", "L4", 2, 16, 128, 0.39, 0.45),
    ("llama2-7b", "L4", 2, 16, 256, 0.79, 0.77),
]
TPS = (2, 4, 8)
CHECK_TP, CHECK_LENS, FIT_LEN = 4, (512, 2048), 2048


def fit_h100(ttft_uncompressed_2048_s: float, launch_floor_s: float, quant_s: float,
             reduce_s: float, arch: str = "llama2-7b") -> Dict[str, float]:
    """The H100 entry's fitted constants from the card: ``mfu`` from the
    graphed uncompressed ``measure_ttft`` at 2048 tokens (one card: the
    whole model's prefill FLOPs over its time at the data-sheet peak);
    ``codec_fixed_s`` two launches (quantize, dequantize-and-sum) at the
    launch floor; ``codec_passes`` the HBM passes over the TP partials that
    the codec's device time at the whole-prompt shapes of 512 tokens, TP 4
    (``quant_s`` of (2048, d) and ``reduce_s`` of 4 x (512, d), each
    launch floor included) is worth beyond the fixed cost."""
    cfg, hw = get_config(arch), HARDWARE["H100"]
    mfu = 2.0 * cfg.active_param_count() * FIT_LEN / (hw.peak_flops * ttft_uncompressed_2048_s)
    fixed = 2.0 * launch_floor_s
    partial_bytes = CHECK_TP * 512 * cfg.d_model * 2.0
    passes = (quant_s + reduce_s - fixed) * hw.hbm_bw / partial_bytes
    return {"mfu": mfu, "codec_fixed_s": fixed, "codec_passes": passes}


def table() -> str:
    """The predicted TTFT at TP 2/4/8 on the H100 entry beside each of the
    paper's rows."""
    hw, spec = HARDWARE["H100"], PAPER_DEFAULT.spec
    head = (f"model       batch x seq  paper (hw x tp: uncompressed / compressed s)   "
            + "   ".join(f"H100 TP {tp}: un / comp s (speedup)" for tp in TPS))
    lines = [head]
    for model, p_hw, p_tp, b, s, p_un, p_c in PAPER_ROWS:
        cfg = get_config(model)
        cells = []
        for tp in TPS:
            un = ttft_breakdown(cfg, hw, tp, b, s)["total"]
            co = ttft_breakdown(cfg, hw, tp, b, s, spec)["total"]
            cells.append(f"{un:.4f} / {co:.4f} ({un / co:.2f}x)")
        lines.append(f"{model:11s} {b:5d} x {s:<4d}  {p_hw:4s} x {p_tp}: {p_un:.2f} / {p_c:.2f} "
                     f"({p_un / p_c:.2f}x)                 " + "   ".join(cells))
    return "\n".join(lines)


def one_card_check(measured: Optional[Dict[int, Tuple[float, float]]] = None
                   ) -> Tuple[str, Dict[int, Dict[str, float]]]:
    """The model's codec term for llama2-7b at TP 4 against the measured
    (compressed s, uncompressed s) ``measure_ttft`` by prompt length.
    Returns (text, {length: {"model_codec_s", "measured_codec_s" or None}})."""
    cfg, hw, spec = get_config("llama2-7b"), HARDWARE["H100"], PAPER_DEFAULT.spec
    out, lines = {}, []
    for n in CHECK_LENS:
        model_codec = ttft_breakdown(cfg, hw, CHECK_TP, 1, n, spec)["codec"]
        got = measured.get(n) if measured else None
        meas = got[0] - got[1] if got else None
        out[n] = {"model_codec_s": model_codec, "measured_codec_s": meas}
        lines.append(
            f"one card, llama2-7b, {n} tokens, simulate_tp {CHECK_TP}: model codec term "
            f"{model_codec * 1e3:.3f} ms; measured graphed compressed - uncompressed "
            + (f"{meas * 1e3:.3f} ms ({got[0] * 1e3:.3f} - {got[1] * 1e3:.3f})" if got
               else "not measured"))
    return "\n".join(lines), out


def measured_from(ttft: Dict[str, Dict[str, float]]) -> Dict[int, Tuple[float, float]]:
    """(compressed s, uncompressed s) by prompt length of the graphed
    ``measure_ttft`` runs in ``chip_smoke.py``'s record (its ``serve.ttft``:
    ``compressed/N`` and ``uncompressed/N``, each with ``median_s``)."""
    return {n: (ttft[f"compressed/{n}"]["median_s"], ttft[f"uncompressed/{n}"]["median_s"])
            for n in CHECK_LENS if f"compressed/{n}" in ttft}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--measured", default=None,
                    help="chip_smoke.py's record (chiprun_out/chip_smoke.json) to read the "
                         "measured measure_ttft from")
    args = ap.parse_args(argv)
    hw = HARDWARE["H100"]
    print(f"# Table 3 on the analytic model, {hw.name}: peak {hw.peak_flops / 1e12:.0f} "
          f"TFLOP/s, HBM {hw.hbm_bw / 1e12:.2f} TB/s, link {hw.link_bw / 1e9:.0f} GB/s, "
          f"mfu {hw.mfu:.4f}, codec {hw.codec_passes:.3f} passes + "
          f"{hw.codec_fixed_s * 1e6:.2f} us per reduction; compressed = "
          f"{PAPER_DEFAULT.describe()}")
    print(table())
    measured = (measured_from(json.loads(pathlib.Path(args.measured).read_text())["serve"]["ttft"])
                if args.measured else None)
    print(one_card_check(measured)[0])


if __name__ == "__main__":
    main()
