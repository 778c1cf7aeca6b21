"""The files a configuration's recipe reads, written once into a fixed
directory of the checkout (``bench_port/.cache/<config>``) from the
configuration's ``assets`` block, in the layouts the recipe's relative
paths name: ``data/YCB_models_process``, ``data/YCB_models_supp``,
``data/HTML_supp``, ``assets/grasp_engine/ycb_grasp``,
``assets/synth_bg``, ``assets/mano_v1_2/models/MANO_RIGHT.pkl`` and
``assets/extend_models_info.json``. A run works from that directory, so
the program's own caches there (the CCV blacklist) persist from run to
run as well."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict

import numpy as np

from bench_port.gen import layouts, mano_standin

BENCH = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(BENCH, ".cache")
MARKER = "ASSETS_OK"


def assets_key(cfg: Dict) -> str:
    objs = cfg["recipe"]["MANAGER"]["OBJ_ENGINE"]["OBJ"]
    blob = json.dumps({"assets": cfg["assets"], "objs": objs,
                       "models_info": cfg.get("models_info")}, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def write_assets(cfg: Dict, root: str) -> None:
    a = cfg["assets"]
    objs = cfg["recipe"]["MANAGER"]["OBJ_ENGINE"]["OBJ"]
    rng = np.random.RandomState(a["seed"])
    m, s = a["ycb_mesh"], a["ycb_supp_mesh"]
    layouts.write_ycb_models(os.path.join(root, "data", "YCB_models_process"), objs, rng,
                             n_lat=m["n_lat"], n_lon=m["n_lon"], tex_size=m["tex_size"])
    layouts.write_ycb_models(os.path.join(root, "data", "YCB_models_supp"), objs, rng,
                             n_lat=s["n_lat"], n_lon=s["n_lon"], tex_size=s["tex_size"],
                             mesh_name="textured_simple_ds.obj")
    layouts.write_grasps(os.path.join(root, "assets", "grasp_engine", "ycb_grasp"), objs,
                         a["grasps_per_object"], rng)
    layouts.write_backgrounds(os.path.join(root, cfg["recipe"]["MANAGER"]["RENDERER"]["BGS_PATH"]),
                              a["backgrounds"], rng)
    mano_standin.write_mano_pickle(os.path.join(root, "assets", "mano_v1_2"),
                                   a["mano_standin_seed"])
    hand = mano_standin.synthetic_mano_arrays(a["mano_standin_seed"])
    layouts.write_html_hands(os.path.join(root, "data", "HTML_supp"), a["html_hands"],
                             hand["v_template"], hand["f"], rng, tex_size=a["html_tex_size"])
    if cfg.get("models_info") is not None:
        with open(os.path.join(root, "assets", "extend_models_info.json"), "w") as f:
            json.dump(cfg["models_info"], f)


def ensure_assets(cfg: Dict, cache: str = CACHE) -> str:
    """The configuration's asset directory, written first where it is
    missing or was written from other parameters."""
    root = os.path.join(cache, cfg["name"])
    key = assets_key(cfg)
    marker = os.path.join(root, MARKER)
    if os.path.isfile(marker) and open(marker).read() == key:
        return root
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    write_assets(cfg, root)
    with open(marker, "w") as f:
        f.write(key)
    return root
