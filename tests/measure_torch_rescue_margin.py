"""How the port's rescue cascade differs from the JAX package's, rectangle
by rectangle.

    python tests/measure_torch_rescue_margin.py \
        [--ref tests/data/torch_scene2_3072_rescue_jax_reference.npz] \
        [--views 0 1 2] [--device cpu] [--shuffles 3]

Renders the facade views of a rescue reference file
(``tests/make_torch_lsd_reference.py --rescue``, which stores the segments
of the rectangles JAX rescued), runs the port's detector with the rescue
cascade on ``--device`` and prints, per view: the rescued rectangles per
round; for every rectangle JAX rescued, the distance (larger endpoint
distance, pixels) to the port's nearest accepted segment and to the port's
nearest component of any kind, with that component's state and the best
log NFA of its 16 rescue variants (the cascade accepts above 0); and the
same for every rectangle the port rescued against JAX's accepted segments.
With ``--shuffles N`` (CPU only) it then repeats the detection with the
float32 moment terms summed in float32 in list order and in N random
orders (``tests/measure_torch_lsd_facade.py``: equally valid evaluations
of the same sums) and prints each order's rescued rectangles per round.
Imports no JAX.  Not collected by pytest.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from line3dpp_tpu_torch.ops import lsd, lsd_fit  # noqa: E402
from line3dpp_tpu_torch.utils import golden, synthetic  # noqa: E402


def rescue_state(img: torch.Tensor):
    """The port's detection of one image with the rescue cascade: the
    segments of all components as numpy, and per component ``ok``,
    ``rescued``, ``attempt`` and the best rescue variant's log NFA."""
    diag = {}
    segs, ok, st = lsd._lsd_core(img, rescue=True, diag=diag)
    return dict(segs=segs.cpu().numpy().astype(np.float64),
                ok=ok.cpu().numpy(), stats=st,
                **{k: diag[k].cpu().numpy()
                   for k in ("rescued", "attempt", "nfa")})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", default=os.path.join(
        REPO, "tests", "data", "torch_scene2_3072_rescue_jax_reference.npz"))
    ap.add_argument("--views", type=int, nargs="*")
    ap.add_argument("--device", default=None)
    ap.add_argument("--shuffles", type=int, default=0)
    opts = ap.parse_args()
    dev = lsd._default_device(opts.device)
    torch.set_num_threads(4)

    with np.load(opts.ref) as data:
        ref = {k: data[k] for k in data.files}
    W, H, V = int(ref["width"]), int(ref["height"]), len(ref["seg_counts"])
    quads, _ = synthetic.build_scene()
    cams = synthetic.make_cameras(10, width=W, height=H)[:V]
    ref_segs = np.split(ref["segments"], np.cumsum(ref["seg_counts"])[:-1])
    ref_res = np.split(ref["rescued_segments"],
                       np.cumsum(ref["n_rescue"])[:-1])
    for i in (opts.views if opts.views else range(V)):
        image = synthetic.render(cams[i], quads, seed=100 + i,
                                 ss=int(ref["ss"]))
        assert synthetic.image_digest(image) == ref["digests"][i]
        s = rescue_state(lsd._prepare(image, -1, dev)[0])
        per_round = [r["n_rescue"] for r in s["stats"]["rounds"]]
        print(f"view {i}: port rescued {per_round}, JAX "
              f"{len(ref_res[i])} in all", flush=True)
        d_ok, _ = golden.nearest_segment(ref_res[i], s["segs"][s["ok"]])
        d_any, j = golden.nearest_segment(ref_res[i], s["segs"])
        for k, seg in enumerate(ref_res[i]):
            print(f"  JAX rescued {np.round(seg, 2).tolist()} (length "
                  f"{np.hypot(*(seg[2:] - seg[:2])):.1f}): port's nearest "
                  f"accepted {d_ok[k]:.3f} px; nearest component "
                  f"{d_any[k]:.3f} px, ok {bool(s['ok'][j[k]])}, rescued "
                  f"{bool(s['rescued'][j[k]])}, attempt "
                  f"{bool(s['attempt'][j[k]])}, best NFA "
                  f"{s['nfa'][j[k]]:.4f}", flush=True)
        mine = np.nonzero(s["rescued"])[0]
        d_jax, _ = golden.nearest_segment(s["segs"][mine], ref_segs[i])
        for k, c in enumerate(mine):
            seg = s["segs"][c]
            print(f"  port rescued {np.round(seg, 2).tolist()} (length "
                  f"{np.hypot(*(seg[2:] - seg[:2])):.1f}), best NFA "
                  f"{s['nfa'][c]:.4f}: JAX's nearest accepted "
                  f"{d_jax[k]:.3f} px", flush=True)
        if opts.shuffles:
            from measure_torch_lsd_facade import moments_f32

            shipped, counts = lsd_fit.moments_plain, {}
            for name, seed in [("f32", None)] + [
                    (f"f32-s{n}", n) for n in range(opts.shuffles)]:
                lsd_fit.moments_plain = moments_f32(seed)
                try:
                    st = lsd._lsd_core(lsd._prepare(image, -1, dev)[0],
                                       rescue=True)[2]
                finally:
                    lsd_fit.moments_plain = shipped
                counts[name] = [r["n_rescue"] for r in st["rounds"]]
            print(f"  rescued per round under other summation orders: "
                  f"{counts}", flush=True)


if __name__ == "__main__":
    main()
