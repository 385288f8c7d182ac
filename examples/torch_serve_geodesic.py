"""End-to-end serving demo on ``repro_torch.serve``, the PyTorch/CUDA
port's service (the counterpart of ``examples/serve_geodesic.py``): a
stream of heterogeneous
image requests flows through the shape-bucketed micro-batching service
— bucketing, compiled-plan caching, double-buffered execution and
demuxing all happen inside the subsystem (no hand-rolled batching
loop), and the run ends with the service's own metrics report
(per-bucket latency percentiles, batch occupancy, cache hit-rate, the
paper's FPS / MPx-per-s headline numbers).

    PYTHONPATH=src python examples/torch_serve_geodesic.py [--frames 24]
        [--size 256] [--batch 4] [--backend cuda|torch] [--mixed-sizes]
        [--device cpu]

``--device`` defaults to the GPU, where the ``"cuda"`` engine launches
the hand-written kernels; ``--device cpu`` runs their plain versions.

The service is declared as data (``SERVICE``): operator names + params
resolved through the registry.  ``--mixed-sizes`` varies frame shapes to
exercise pad-to-bucket canonicalization; frames of different sizes that
round to the same bucket share one compiled program.  Buckets are keyed
on the *lowered run signature*, so HMAX, DOME and RAOBJ — all one
dilate-reconstruction after their prepare stages — co-batch into a
single ``rec:dilate`` bucket (cross-op packing; watch its occupancy in
the report).
"""
import argparse
import json

import numpy as np

from repro_torch.data.images import basins, blobs, border_objects
from repro_torch.serve import Service

#: The served operator mix, declared as data: (op name, params).
SERVICE = (
    ("hmax", {"h": 40}),
    ("dome", {"h": 40}),
    ("hfill", {}),
    ("raobj", {}),
    ("open_rec", {"s": 8}),
    ("erode", {"s": 16}),
    ("asf", {"s": 3}),
)

_KINDS = (blobs, basins, border_objects)


def make_frames(n, size, mixed_sizes):
    """Alternating image kinds (different convergence behaviour, like
    the paper's Male/Airport/Airplane), optionally ragged sizes."""
    frames = []
    for i in range(n):
        h = w = size
        if mixed_sizes:
            h = size - 16 * (i % 3)
            w = size - 8 * (i % 5)
        frames.append(_KINDS[i % 3](h, w, np.uint8, seed=i))
    return frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4,
                    help="max micro-batch size per bucket")
    ap.add_argument("--backend", choices=("cuda", "torch"), default="cuda")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--max-delay-ms", type=float, default=50.0)
    ap.add_argument("--mixed-sizes", action="store_true",
                    help="vary frame shapes to exercise bucket padding")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the full metrics summary as JSON")
    args = ap.parse_args()

    service = Service(
        backend=args.backend,
        max_batch=args.batch,
        max_delay_ms=args.max_delay_ms,
        pad_quantum=64,
        device=args.device,
    )
    frames = make_frames(args.frames, args.size, args.mixed_sizes)

    # Warm-up prefill: compile one program per (op, bucket, batch size)
    # before traffic arrives, so the stream below measures steady-state.
    # Every canonical batch size (powers of two up to --batch) is warmed
    # so deadline flushes and leftover partial batches also hit.
    batch_sizes, b = {args.batch}, 1
    while b < args.batch:
        batch_sizes.add(b)
        b *= 2
    shapes = sorted({f.shape for f in frames})
    service.warmup(
        {"op": op, "params": params, "shape": s, "dtype": np.uint8,
         "batch": b}
        for op, params in SERVICE for s in shapes
        for b in sorted(batch_sizes)
    )

    print(f"geodesic serve: {args.frames} frames @ ~{args.size}px u8, "
          f"{len(SERVICE)} ops, max_batch={args.batch}, "
          f"backend={args.backend}, device={args.device or 'cuda'}")

    # The request stream: every frame fans out to every configured op.
    tickets = [
        service.submit(op, f, params=params)
        for f in frames for op, params in SERVICE
    ]
    service.flush()
    for t in tickets:          # surfaces any per-request failure
        t.result()

    stats = service.stats()
    print(f"\n{'bucket':44s} {'req':>4s} {'occ':>5s} {'p50ms':>8s} "
          f"{'p99ms':>8s} {'FPS':>7s} {'MPx/s':>8s}")
    for label, b in stats["buckets"].items():
        print(f"{label:44s} {b['requests']:4d} {b['batch_occupancy']:5.2f} "
              f"{b['latency']['p50_ms']:8.1f} {b['latency']['p99_ms']:8.1f} "
              f"{b['fps']:7.1f} {b['mpx_per_s']:8.2f}")
    tot, cache = stats["totals"], stats["cache"]
    print(f"\ntotals: {tot['requests']} requests, "
          f"occupancy={tot['batch_occupancy']:.2f}, "
          f"fps={tot['fps']:.1f}, mpx/s={tot['mpx_per_s']:.2f}")
    print(f"cache:  {cache['entries']} programs, "
          f"hit_rate={cache['hit_rate']:.2f} "
          f"({cache['hits']} hits / {cache['misses']} misses, "
          f"{cache['warm_builds']} warm)")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(stats, fh, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
