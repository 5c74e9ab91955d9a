"""The upstream testdata scene: 26 oriented views with their cached 2D
segments, read from the repository's ``testdata/cameras_testdata.json``
and ``testdata/L3D_cache/`` (the configuration's ``cameras`` and
``segments`` files).

Each scene of a run moves every cached endpoint by its own uniform draw in
``[-jitter_px, jitter_px]`` (the configuration's ``assumed.jitter_px``),
made from the run's seed and the scene's index, so that no two scenes of
any run share inputs while every scene does the same work as the upstream
scene.  Scene -1 is the set-up's warm-up scene.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import seed_words

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Source:
    def __init__(self, config: dict, spec: dict, seed: int, device=None):
        with open(os.path.join(ROOT, config["cameras"])) as f:
            cams = json.load(f)
        ids = sorted(int(c) for c in cams)
        keep = config.get("views_used")
        cap = config.get("segments_used")
        self.views = []
        for cam_id in ids[:None if keep is None else int(keep)]:
            c = cams[str(cam_id)]
            w, h = int(c["width"]), int(c["height"])
            with np.load(os.path.join(ROOT, config["segments"].format(
                    cam=cam_id, width=w, height=h))) as z:
                segs = np.asarray(z["segments"], np.float64)
            if cap is not None:
                segs = segs[:int(cap)]
            self.views.append((cam_id, np.array(c["K"], np.float64),
                               np.array(c["R"], np.float64),
                               np.array(c["t"], np.float64), w, h, segs))
        self.jitter = float(config["assumed"]["jitter_px"])
        self.seed = seed

    @property
    def views_per_scene(self) -> int:
        return len(self.views)

    def scene(self, index: int) -> dict:
        rng = np.random.default_rng(seed_words(self.seed, index + 1))
        views = []
        for cam_id, K, R, t, w, h, segs in self.views:
            move = rng.uniform(-self.jitter, self.jitter, size=segs.shape)
            views.append((cam_id, K, R, t, w, h, segs + move))
        return dict(kind="cached", index=index, views=views)
