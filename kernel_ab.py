"""Compare the hand-written kernels of several source trees on one card.

    PYTHONPATH=src python3 kernel_ab.py --trees .archive/parent . \\
        --order 0,1,1,0 [--profile-order 0,1,1,0]

A tree is a directory holding ``src/repro_torch`` (this checkout, or an
older commit unpacked with ``git archive``). For each tree, ``nvcc -Xptxas
-v`` on the sources of the phase's kernels (the codec's for ``--phase
phase_codec``, every source otherwise) reads every kernel's registers,
spills and stack.
Then, in the order given (indices into ``--trees``), one process per run
with that tree's ``src`` first on ``PYTHONPATH`` calls ``phase_kernels`` of
this checkout's ``chip_smoke.py`` (``--phase phase_codec`` for the codec
kernels alone, ``--phase phase_paged`` for paged attention alone): the same
checks and timed shapes on each tree's kernels,
each tree built into its own ``_build``. ``--profile-order`` runs
``repro_torch.launch.profile_serve`` per tree the same way, on both cells
(fp4 and bf16 pools) in turns: device ms by layer of the served step. The
compile flags are the build's (``repro_torch.kernels.build``, from this
checkout's ``src`` on ``PYTHONPATH``). Everything goes to
``chiprun_out/kernel_ab.json``; a summary is printed. Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

from repro_torch.kernels.build import NVCC_FLAGS, SOURCES, _nvcc

ROOT = pathlib.Path(__file__).resolve().parent
CODEC_SOURCES = ("mx_quant.cu", "mx_dequant.cu", "mx_dequant_reduce.cu")
CELLS = "fp4_e2m1,bf16,bf16,fp4_e2m1"   # profile_serve's cells, in turns

KERNEL_RUN = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke
info = chip_smoke.{phase}(torch)
open({out!r}, "w").write(json.dumps(info, default=str))
"""


def ptxas_report(tree: pathlib.Path, sources):
    """Registers, spill bytes and stack frame of every kernel in the tree's
    ``sources``, compiled as the build compiles them (objects into the
    tree's ``_build``)."""
    nvcc = _nvcc()
    csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
    out_dir = csrc.parent / "_build" / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(csrc / src),
         "-o", str(out_dir / f"{src}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for src in sources]
    entries = []
    for src, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / src}:\n{text}")
        cur = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = dict(source=src, symbol=m.group(1))
                entries.append(cur)
            elif cur is not None and "spill stores" in line:
                nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
                cur.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
            elif cur is not None and "Used" in line and "registers" in line:
                cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    filt = shutil.which("c++filt")
    if filt and entries:
        names = subprocess.run([filt], input="\n".join(e["symbol"] for e in entries),
                               capture_output=True, text=True).stdout.splitlines()
        for e, name in zip(entries, names):
            e["name"] = name
    return entries


def child_env(tree: pathlib.Path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tree / "src")
    env.pop("REPRO_TORCH_BUILD_DIR", None)  # each tree builds into its own _build
    return env


def run_kernels(tree: pathlib.Path, out: pathlib.Path, phase: str):
    code = KERNEL_RUN.format(root=str(ROOT), out=str(out), phase=phase)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=child_env(tree),
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{phase} on {tree} failed:\n{res.stdout[-4000:]}\n"
                           f"{res.stderr[-4000:]}")
    return json.loads(out.read_text())


def run_profile(tree: pathlib.Path, out: pathlib.Path):
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.profile_serve",
                          "--cache-spec", CELLS, "--out", str(out)],
                         cwd=ROOT, env=child_env(tree), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"profile_serve on {tree} failed:\n{res.stdout[-4000:]}\n"
                           f"{res.stderr[-4000:]}")
    return json.loads(out.read_text())


def kernel_times(info):
    """(label, device ms) of every timed kernel shape in one phase_kernels run."""
    rows = []
    q = info.get("mx_quant", {})
    for r in ([q] + q.get("shapes", [])) if q else []:
        rows.append((f"mx_quant {r['shape']}", r["ms"]))
    for name in ("mx_dequant", "mx_dequant_reduce"):
        if name in info:
            rows.append((f"{name} {info[name]['shape']}", info[name]["ms"]))
    pa = info.get("paged_attention", {})
    for r in ([pa] if pa else []) + pa.get("geometries", []):
        if "ms" in r:
            rows.append((f"paged_attention {r['geometry']}/{r['pools']}", r["ms"]))
    if "launch_floor_ms" in q:
        rows.append(("launch floor (add on one element)", q["launch_floor_ms"]))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--order", default="", help="comma-separated tree indices for --phase")
    ap.add_argument("--phase", default="phase_kernels",
                    choices=("phase_kernels", "phase_codec", "phase_paged"),
                    help="chip_smoke phase to run: every kernel, the codec kernels only, or "
                         "paged attention only")
    ap.add_argument("--profile-order", default="",
                    help="comma-separated tree indices for profile_serve")
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    args = ap.parse_args(argv)

    trees = [pathlib.Path(t).resolve() for t in args.trees]
    out = pathlib.Path(args.out)
    work = out.parent / "kernel_ab"
    work.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "trees": [str(t) for t in trees], "ptxas": {}, "kernels": [],
              "profile": []}
    sources = CODEC_SOURCES if args.phase == "phase_codec" else SOURCES
    for i, tree in enumerate(trees):
        entries = result["ptxas"][str(i)] = ptxas_report(tree, sources)
        for e in entries:   # the instances the served step launches (bf16, 4-bit codes),
            name = e.get("name", e["symbol"])   # and every paged instance
            if "paged" in name or ("bfloat16" in name and (
                    "reduce" in name or re.search(r"<__nv_bfloat16(, 4\b|>)", name))):
                print(f"ptxas tree {i}: {name[:90]}: {e.get('registers')} registers, "
                      f"{e.get('spill_stores')}/{e.get('spill_loads')} bytes spilled "
                      f"(stores/loads), {e.get('stack')} bytes stack", flush=True)
        print(f"ptxas tree {i}: all {len(entries)} kernels of {', '.join(sources)}: at most "
              f"{max(e.get('registers', 0) for e in entries)} registers, "
              f"{sum(e.get('spill_stores', 0) + e.get('spill_loads', 0) for e in entries)} "
              f"bytes spilled, {max(e.get('stack', 0) for e in entries)} bytes stack", flush=True)
    for n, i in enumerate(int(k) for k in args.order.split(",") if k):
        info = run_kernels(trees[i], work / f"kernels_{n}_tree{i}.json", args.phase)
        result["kernels"].append({"tree": i, "info": info})
        for label, ms in kernel_times(info):
            print(f"run {n} tree {i}: {label}: {ms:.4f} ms", flush=True)
    for n, i in enumerate(int(k) for k in args.profile_order.split(",") if k):
        cells = run_profile(trees[i], work / f"profile_{n}_tree{i}.json")
        result["profile"].append({"tree": i, "cells": cells})
        for c in cells:
            cat = c["device_ms_by_category"]
            print(f"profile {n} tree {i} {c['cache_spec']}: " + ", ".join(
                f"{k} {cat.get(k, 0.0):.1f}" for k in ("paged_attention", "mx_codec", "gemm",
                                                       "other"))
                  + f" ms; busy {sum(cat.values()):.1f} ms; wall {c['plain_wall_ms']:.1f} ms "
                    f"unprofiled", flush=True)
    out.write_text(json.dumps(result, indent=1, default=str))


if __name__ == "__main__":
    main()
