"""Roofline report: reads the dry run's JSON records, emits the per-cell
three-term table and ranks hillclimb candidates — the port of
``repro/launch/roofline.py``, on the H100's ``PEAK_FLOPS``.

    PYTHONPATH=src python -m repro_torch.launch.roofline results/dryrun \\
        [--mesh 16x16]

The "fits" column reads ``fits_80g`` (``launch.analytic.HBM_CAPACITY``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.analytic import PEAK_FLOPS


def load(directory: str) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def enrich(r: dict) -> dict:
    if not r.get("ok"):
        return r
    chips = r["chips"]
    if r["arch"] == "geodesic2d":
        # elementwise workload: terms are the elementwise-rate model of
        # the dry run itself (its dot FLOPs are ~0)
        r["step_s_bound"] = max(r["compute_s"], r["memory_s"],
                                r["collective_s"])
        return r
    # prefer the counted dot flops (remat recompute included) for the
    # compute term; analytic model_flops gives the usefulness ratio
    hlo_f = r.get("hlo_dot_flops_per_device")
    if hlo_f:
        r["compute_s_hlo"] = hlo_f / PEAK_FLOPS
    total_s = max(r.get("compute_s_hlo", r["compute_s"]),
                  r["memory_s"], r["collective_s"])
    r["step_s_bound"] = total_s
    useful = r.get("model_flops", 0.0) / (chips * PEAK_FLOPS)
    r["roofline_frac"] = useful / total_s if total_s else 0.0
    if hlo_f and r.get("model_flops"):
        r["useful_ratio"] = r["model_flops"] / (hlo_f * chips)
    dom = {"compute": r.get("compute_s_hlo", r["compute_s"]),
           "memory": r["memory_s"], "collective": r["collective_s"]}
    r["dominant"] = max(dom, key=dom.get)
    return r


def table(rows: list[dict], mesh: str | None = None) -> str:
    out = ["| arch | shape | mesh | GB/dev | fits | compute_s | memory_s "
           "| collective_s | dominant | MODEL/HLO | roofline |",
           "|---|---|---|---|---|---|---|---|---|---|---|"[:-4]]
    for r in rows:
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"FAILED: {r.get('error', '?')[:40]} |")
            continue
        if mesh and r["mesh"] != mesh:
            continue
        out.append(
            "| {arch} | {shape} | {mesh} | {gb:.1f} | {fits} | {c:.3f} | "
            "{m:.3f} | {k:.3f} | {dom} | {ur} | {rf:.1%} |".format(
                arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                gb=r["bytes_per_device"] / 1e9,
                fits="Y" if r.get("fits_80g") else "N",
                c=r.get("compute_s_hlo", r.get("compute_s", 0.0)),
                m=r["memory_s"], k=r["collective_s"],
                dom=r["dominant"],
                ur=(f"{r['useful_ratio']:.2f}"
                    if r.get("useful_ratio") else "-"),
                rf=r.get("roofline_frac", 0.0),
            ))
    return "\n".join(out)


def hillclimb_candidates(rows: list[dict]) -> dict:
    ok = [r for r in rows if r.get("ok") and r["arch"] != "geodesic2d"
          and r["mesh"] == "16x16"]
    worst = min(ok, key=lambda r: r.get("roofline_frac", 1.0))
    coll = max(ok, key=lambda r: r.get("collective_s", 0.0))
    return {"worst_roofline": f"{worst['arch']}×{worst['shape']}",
            "most_collective_bound": f"{coll['arch']}×{coll['shape']}"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    rows = [enrich(r) for r in load(args.directory)]
    print(table(rows, args.mesh))
    print()
    if any(r.get("ok") and r["arch"] != "geodesic2d"
           and r["mesh"] == "16x16" for r in rows):
        print("hillclimb candidates:", hillclimb_candidates(rows))


if __name__ == "__main__":
    main()
