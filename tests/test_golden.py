"""Golden-image anchors (SURVEY.md §4): fixed-seed renders hashed against
recorded references. Catches any unintended change to the estimator, RNG,
camera, or scene pipeline. Regenerate with
``python -m tests.test_golden regen`` after an *intentional* change.
"""

import json
import os

# Goldens are CPU anchors. Under pytest, conftest forces CPU; when run
# directly (``python -m tests.test_golden regen``) we force it HERE, before
# any vkrt import, or the regen would record the accelerator's numerics,
# which the (CPU) test can never reproduce.
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from vkrt.config import RenderSettings
from vkrt.engine import Engine
from vkrt.scene import make_cornell_box

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden.json")
W, H = 64, 48

CASES = {
    # config (1) of BASELINE.json: 1 spp, 1 bounce diffuse-only reference
    "path_1spp_1bounce_f1": dict(
        settings=RenderSettings(rt_mode=1, samples=1, depth=1), frames=1
    ),
    "path_default_f4": dict(
        settings=RenderSettings(rt_mode=1, samples=1, depth=3), frames=4
    ),
    "path_2spp_d5_f2": dict(
        settings=RenderSettings(rt_mode=1, samples=2, depth=5), frames=2
    ),
    "hybrid_default_f2": dict(
        settings=RenderSettings(rt_mode=0), frames=2
    ),
    "hybrid_gi_f2": dict(
        settings=RenderSettings(rt_mode=0, use_gi=True), frames=2
    ),
}


def _render(case) -> np.ndarray:
    e = Engine(make_cornell_box(), W, H, case["settings"])
    return e.render(frames=case["frames"])


def _digest(img: np.ndarray) -> dict:
    import hashlib

    return {
        "sha256": hashlib.sha256(img.tobytes()).hexdigest(),
        "mean": round(float(img.mean()), 4),
    }


def test_golden_images():
    assert os.path.exists(GOLDEN_PATH), "golden.json missing — run regen"
    golden = json.load(open(GOLDEN_PATH))
    failures = {}
    for name, case in CASES.items():
        img = _render(case)
        got = _digest(img)
        want = golden.get(name)
        if want is None or got["sha256"] != want["sha256"]:
            failures[name] = {"got": got, "want": want}
    assert not failures, f"golden mismatches: {failures}"


def regen():
    out = {}
    for name, case in CASES.items():
        out[name] = _digest(_render(case))
        print(name, out[name])
    json.dump(out, open(GOLDEN_PATH, "w"), indent=1)
    print(f"wrote {GOLDEN_PATH}")


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        import jax

        jax.config.update("jax_platforms", "cpu")
        regen()
