"""Interactive scribble segmentation served through
``repro_torch.serve``, the PyTorch/CUDA port (the counterpart of
``examples/segment_scribbles.py``): the incremental marker-update
pattern on the generalised geodesic distance subsystem
(``repro_torch.gdt``).

The image is pinned on the service **once** (``service.pin``); every
round then submits only a cheap scribble-plane update, passing the
pinned name in place of the array — the cached-image path (watch the
``asset_hits`` counter climb).  Each round refines the previous one's
scribbles, the way an annotator would: a couple of seed taps first,
then corrective strokes where the last segmentation leaked.

Each ``seg_scribble`` request lowers to *two* gdt kernel segments over
the shared image (foreground + background distance maps) compared in
the finalize phase; a raw ``gdt`` distance request rides along to show
the single-kernel refillable path under the same service.

    PYTHONPATH=src python examples/torch_segment_scribbles.py [--size 64]
        [--backend cuda|torch] [--rounds 3] [--continuous] [--device cpu]

``--device`` defaults to the GPU; ``--device cpu`` runs the kernels'
plain versions.
"""
import argparse

import numpy as np

from repro_torch.data.images import blobs
from repro_torch.serve import Service


def make_image(size: int) -> np.ndarray:
    """A float32 blob field — bright objects on a dark background, the
    grey-weighted cost's terrain."""
    return blobs(size, size, np.uint8, seed=3).astype(np.float32) / 255.0


def scribble_rounds(img: np.ndarray, rounds: int):
    """Progressively refined scribble planes (0 = unmarked, 1 = fg,
    2 = bg): round 0 taps one bright and one dark pixel; later rounds
    add strokes along a bright row / dark column, as an annotator
    correcting the boundary would."""
    h, w = img.shape
    flat = img.ravel()
    fg0 = np.unravel_index(int(flat.argmax()), img.shape)
    bg0 = np.unravel_index(int(flat.argmin()), img.shape)
    s = np.zeros(img.shape, np.float32)
    s[fg0], s[bg0] = 1.0, 2.0
    yield s.copy()
    for r in range(1, rounds):
        k = (r * h) // rounds
        row = np.clip(fg0[0] + (k - h // 2) // 4, 0, h - 1)
        col = np.clip(bg0[1] + (k - w // 2) // 4, 0, w - 1)
        s[row, w // 4: 3 * w // 4: 2] = 1.0   # stroke through the object
        s[:: 2, col] = 2.0                    # stroke over the background
        s[fg0], s[bg0] = 1.0, 2.0
        yield s.copy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--backend", choices=("cuda", "torch"), default="cuda")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--continuous", action="store_true",
                    help="run refillable buckets on the continuous "
                         "slot-refill engine")
    args = ap.parse_args()

    img = make_image(args.size)
    lamb, nu = 1.0, float(2 * args.size)
    service = Service(backend=args.backend, max_batch=4, pad_quantum=16,
                      continuous=args.continuous, device=args.device)

    # Pin the (conceptually large, unchanging) image once; every round
    # below streams only the scribble update against the pinned name.
    service.pin("slice", img)

    print(f"scribble segmentation: {args.size}px float32, "
          f"{args.rounds} rounds, backend={args.backend}, "
          f"continuous={args.continuous}, device={args.device or 'cuda'}")
    for rnd, scrib in enumerate(scribble_rounds(img, args.rounds)):
        mask = service.submit(
            "seg_scribble", "slice", scrib,
            params={"lamb": lamb, "nu": nu}).result()
        n_fg = int(np.count_nonzero(scrib == 1.0))
        n_bg = int(np.count_nonzero(scrib == 2.0))
        print(f"  round {rnd}: {n_fg:4d} fg / {n_bg:4d} bg scribbles -> "
              f"foreground {float(np.asarray(mask).mean()):.1%}")

    # A raw distance request against the same pinned image: the
    # single-kernel gdt op is pad-safe and refillable, so with
    # --continuous this lands on the slot-refill engine.
    seeds = np.zeros(img.shape, np.float32)
    seeds[args.size // 2, args.size // 2] = 1.0
    dist = service.submit("gdt", "slice", seeds,
                          params={"lamb": lamb, "nu": nu}).result()
    print(f"  gdt from centre seed: max distance "
          f"{float(np.asarray(dist).max()):.1f}")

    stats = service.stats()
    hits = stats["counters"].get("asset_hits", 0)
    cache = stats["cache"]
    print(f"\npinned-asset hits: {hits} "
          f"({args.rounds} scribble rounds + 1 distance request)")
    print(f"cache: {cache['entries']} programs, "
          f"hit_rate={cache['hit_rate']:.2f}")
    service.close()


if __name__ == "__main__":
    main()
