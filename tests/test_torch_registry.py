"""The port's registry, logger and progress bar (``artiboost_torch/utils/
{registry,logger,etqdm}.py``) against the JAX package's.

- The port registers every name the JAX package registers, in the same
  registry (MODEL, BACKBONE, HEAD, LOSS, DATASET, METRIC), and each name
  builds the port's class from a config through ``build_from_cfg``.
- An unknown ``TYPE`` raises ``KeyError`` naming the registry in
  ``build_arch``, ``build_criterion``, ``build_evaluator`` and
  ``build_dataset``; a real-data type whose data is absent still raises
  ``FileNotFoundError`` first.
- A class registered from outside the package builds from a config.
- ``add_file_handler`` writes the log file; ``etqdm`` is the logging bar
  when stderr is no TTY, and its line is JAX's, word for word.
"""
import logging

import pytest
import torch

import artiboost_tpu.criterions  # noqa: F401  (the JAX package's registrations)
import artiboost_tpu.datasets  # noqa: F401
import artiboost_tpu.metrics  # noqa: F401
import artiboost_tpu.models  # noqa: F401
from artiboost_torch.criterions import build_criterion
from artiboost_torch.datasets.synthetic import build_dataset
from artiboost_torch.metrics.evaluator import build_evaluator
from artiboost_torch.models.arch import build_arch
from artiboost_torch.utils import registry as t_reg
from artiboost_torch.utils.config import load_config
from artiboost_tpu.utils import registry as j_reg

REGISTRIES = ("MODEL", "BACKBONE", "HEAD", "LOSS", "DATASET", "METRIC")
PRESET = load_config("config/synthetic_smoke.yaml")["DATA_PRESET"]
SMALL_HEAD = {"NUM_DECONV_FILTERS": [32, 32], "DEPTH_RESOLUTION": 8}
# the configs each JAX name is built from: the released and smoke configs'
# entries, cut where a default would be large
CONFIGS = {
    "MODEL": {
        "HybridBaseline": dict(load_config("config/synthetic_smoke.yaml")["ARCH"]),
        "HOPRegNet": dict(load_config("config/synthetic_smoke_reg.yaml")["ARCH"]),
        "HoNet": dict(load_config("config/synthetic_smoke_honet.yaml")["ARCH"]),
        "SimpleBaseline": {"BACKBONE": {"TYPE": "ResNet18"},
                           "HEAD": {"TYPE": "IntegralDeconvHead", "NCLASSES": 29, **SMALL_HEAD}},
        "MLP_O": {"LAYERS_N": [512, 128], "OUT_CHANNEL": 6},
    },
    "HEAD": {"IntegralDeconvHead": SMALL_HEAD},
    "DATASET": {"SyntheticHO": {"DATA_SPLIT": "test", "N_SAMPLES": 2, "RAW_SIZE": 64}},
    "METRIC": {**{name: {"VAL_KEYS": ["joints_3d_abs"]}
                  for name in ("Mean3DEPE", "Mean2DEPE", "ValMetricMean3DEPE2")},
               **{name: {"VAL_MIN": 0.0, "VAL_MAX": 0.05, "STEPS": 20}
                  for name in ("Hand3DPCKMetric", "Obj3DPCKMetric", "Hand2DPCKMetric",
                               "Obj2DPCKMetric")}},
}
# the classes each factory of the port returns (a factory stands where
# torch needs arguments flax infers, as JAX's own factories do)
FACTORY_CLASSES = {
    "BACKBONE": "ResNet", "IntegralDeconvHead": "IntegralDeconvHead",
    "ManoBranch": "ManoBranch", "ManoAdaptor": "ManoAdaptor", "MLP_O": "MLP",
    "HybridBaseline": "HybridBaseline", "HOPRegNet": "HOPRegNet", "HoNet": "HoNet",
    "SimpleBaseline": "SimpleBaseline"}
REAL_DATA = ("HO3D", "HO3DV3", "DexYCB", "FPHB")


def _jax_names():
    return [(r, name) for r in REGISTRIES for name in getattr(j_reg, r).module_dict]


def test_every_jax_name_is_registered():
    for r in REGISTRIES:
        assert set(getattr(t_reg, r).module_dict) == set(getattr(j_reg, r).module_dict), r
    assert len(_jax_names()) == 39  # 35 register_module sites, 5 names at resnet.py:95


@pytest.mark.parametrize("registry,name", _jax_names(), ids=lambda x: str(x))
def test_each_jax_name_builds_the_ports_class(registry, name):
    entry = getattr(t_reg, registry).get(name)
    if registry == "DATASET" and name in REAL_DATA:
        assert entry.__name__ == name and entry.__module__.startswith("artiboost_torch.")
        return  # built from files in tests/test_torch_{ho3d,dexycb,fhb}.py
    cfg = {"TYPE": name, **CONFIGS.get(registry, {}).get(name, {})}
    defaults = {"DATA_PRESET": PRESET}
    if registry in ("METRIC", "DATASET"):
        defaults["device"] = "cpu"
    obj = t_reg.build_from_cfg(cfg, getattr(t_reg, registry), defaults)
    want = FACTORY_CLASSES.get(registry, FACTORY_CLASSES.get(name, name))
    assert type(obj).__name__ == want, (name, type(obj))
    assert type(obj).__module__.startswith("artiboost_torch."), type(obj).__module__
    if registry == "BACKBONE":  # the depth the name says
        blocks = sum(len(getattr(obj, f"layer{i}")) for i in range(1, 5))
        assert blocks == {"ResNet18": 8, "ResNet34": 16, "ResNet50": 16, "ResNet101": 33,
                          "ResNet152": 50}[name]


@pytest.mark.parametrize("builder", ["arch", "criterion", "evaluator", "dataset"])
def test_unknown_type_raises_key_error(builder, tmp_path):
    registry = {"arch": "model", "criterion": "loss", "evaluator": "metric",
                "dataset": "dataset"}[builder]
    with pytest.raises(KeyError, match=f"NoSuchType is not in the {registry} registry"):
        if builder == "arch":
            build_arch({"TYPE": "NoSuchType"}, PRESET)
        elif builder == "criterion":
            build_criterion({"CRITERION": [{"TYPE": "NoSuchType"}], "LAMBDAS": [1.0]})
        elif builder == "evaluator":
            build_evaluator([{"TYPE": "LossesMetric"}, {"TYPE": "NoSuchType"}], PRESET,
                            device="cpu")
        else:
            build_dataset({"TYPE": "NoSuchType"}, PRESET, device="cpu")
    # a real-data type whose data is absent still says so first
    with pytest.raises(FileNotFoundError, match="HO3D data not found"):
        build_dataset({"TYPE": "HO3D", "DATA_SPLIT": "train", "DATA_ROOT": str(tmp_path)},
                      PRESET, device="cpu")


def test_a_class_registered_outside_the_package_builds(monkeypatch):
    made = {}

    class UserLoss(torch.nn.Module):
        output_key = "user_loss"

        def __init__(self, SCALE=1.0, **_):
            super().__init__()
            made["loss"] = SCALE

        def draws(self, generator, device):
            return {}

        def __call__(self, preds, targs, draws):
            v = preds["x"].sum() * made["loss"]
            return v, {"user_loss": v}

    class UserMetric:
        def __init__(self, DATA_PRESET=None, device=None, **cfg):
            made["metric"] = (DATA_PRESET, str(device), cfg)

    class UserModel(torch.nn.Module):
        def __init__(self, WIDTH=2, DATA_PRESET=None, **_):
            super().__init__()
            made["model"] = DATA_PRESET
            self.lin = torch.nn.Linear(WIDTH, 1)

        def forward(self, inputs):
            return {"x": self.lin(inputs["image"])}

    for r, cls in (("LOSS", UserLoss), ("METRIC", UserMetric), ("MODEL", UserModel)):
        reg = getattr(t_reg, r)
        # the registry as it was comes back after the test
        monkeypatch.setattr(reg, "_module_dict", dict(reg.module_dict))
        reg.register_module(cls, name="User")  # as a user registers a class
        with pytest.raises(KeyError, match="already registered"):
            reg.register_module(cls, name="User")
    crit = build_criterion({"CRITERION": [{"TYPE": "User", "SCALE": 2.0}], "LAMBDAS": [1.0]})
    ev = build_evaluator([{"TYPE": "User", "X": 1}], PRESET, device="cpu")
    arch = build_arch({"TYPE": "User", "WIDTH": 3}, PRESET)
    assert made["loss"] == 2.0 and made["metric"] == (PRESET, "cpu", {"X": 1})
    assert made["model"] == PRESET and isinstance(ev.metrics_list[0], UserMetric)
    out = arch({"image": torch.ones(2, 3)})
    assert out["x"].shape == (2, 1)
    assert isinstance(crit.loss_list[0], UserLoss)


def test_logger_file_handler(tmp_path):
    from artiboost_torch.utils.logger import add_file_handler, logger
    from artiboost_torch.utils.misc import logger as misc_logger

    assert misc_logger is logger and logger.name == "artiboost_torch"
    path = tmp_path / "sub" / "log.txt"
    fh = add_file_handler(str(path))
    try:
        logger.info("hello file")
        logger.debug("below the level")
    finally:
        logger.removeHandler(fh)
        fh.close()
    lines = path.read_text().splitlines()
    assert len(lines) == 1 and lines[0].endswith(" | INFO | hello file"), lines


def test_etqdm_logs_without_a_tty(caplog):
    from artiboost_torch.utils import etqdm as t_etqdm
    from artiboost_tpu.utils import etqdm as j_etqdm

    lines = {}
    for side, mod, name in (("t", t_etqdm, "artiboost_torch"), ("j", j_etqdm, "artiboost_tpu")):
        bar = mod.etqdm(range(3), desc="TRAIN 0", use_tty=False)
        assert type(bar).__name__ == "_LoggerBar"
        bar.log_interval = 0.0
        bar.set_postfix_str("final_loss: 0.12345")
        with caplog.at_level(logging.INFO, logger=name):
            caplog.clear()
            if side == "j":  # JAX's logger does not propagate: catch its own records
                handler = logging.Handler()
                handler.emit = lambda r: caplog.records.append(r)
                logging.getLogger(name).addHandler(handler)
            try:
                assert list(bar) == [0, 1, 2]
            finally:
                if side == "j":
                    logging.getLogger(name).removeHandler(handler)
            lines[side] = [r.getMessage() for r in caplog.records if r.name == name]
    strip = [[m.split("] ")[0] + "] " + m.split(" it/s ")[1] for m in ms] for ms in
             (lines["t"], lines["j"])]
    assert len(lines["t"]) == 3 and strip[0] == strip[1], lines
    assert lines["t"][0].startswith("TRAIN 0 [1/3] ") and lines["t"][0].endswith(
        " it/s final_loss: 0.12345")
    tty_bar = t_etqdm.etqdm(range(2), desc="VAL 0", use_tty=True)
    assert type(tty_bar).__name__ == "tqdm"  # tqdm is installed here
    tty_bar.close()
