"""The toy configuration of ``graph500_s17`` for ``toy.make_root``: Graph
500's generator with the deployment's own parameters at SCALE 9 (512
vertices, largest degree 269, so the bfloat16 control loses counts)."""

import json
import os

from spbench.tests import toy

with open(os.path.join(toy.SPBENCH, "configs", "graph500_s17.json")) as f:
    toy.TOY_CONFIGS.setdefault("graph500_s17",
                               ("toy_graph500", {**json.load(f), "scale": 9, "n": 512}))
