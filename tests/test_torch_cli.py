"""The port's command line against the JAX package's (``artiboost_tpu/opt.py``).

- Every flag of JAX's ``build_parser`` and of ``parse_extra_args``'s parser
  (read from their ``_actions``, so a flag JAX adds later fails this file)
  is accepted by ``artiboost_torch.train``'s and ``submit_reload``'s parsers
  with the same option strings, type, ``nargs``, choices and default; one
  command line that gives every flag a value other than its default parses
  to JAX's values in both.
- The port parses strictly: an unknown flag raises (JAX's
  ``parse_known_args`` drops it; ROADMAP C, recorded differences).
- A flag an entry point does not read is logged as having no effect.
- ``--filter_unseen_obj_idxs 1 3`` reaches the port's ``Mean3DEPE`` through
  ``build_evaluator(ARG=...)`` and its ``corners_3d_abs`` EPE equals JAX's
  ``Mean3DEPE(ARG=Namespace(...))`` on the same seeded batch (rows of the
  filtered ids, of other ids, and a SAMPLE_VALID mask) to 1e-6 relative;
  the command line's list replaces the config's FILTER_UNSEEN_OBJ_IDXS, as
  in JAX (``meanepe.py:47-52``), and a numpy recomputation that drops those
  rows gives the same figure.
"""
import argparse
import logging

import numpy as np
import pytest

from artiboost_torch import submit_reload, train
from artiboost_torch.utils import opt as t_opt
from artiboost_tpu import opt as j_opt

PORT_PARSERS = {"train": train.build_parser, "submit_reload": submit_reload.build_parser}


def _extra_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser ``parse_extra_args`` builds inside itself."""
    made = []
    orig = argparse.ArgumentParser.parse_known_args

    def spy(self, args=None, namespace=None):
        made.append(self)
        return orig(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", spy)
    j_opt.parse_extra_args([])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", orig)
    return made[0]


def _jax_actions(monkeypatch):
    return [a for p in (j_opt.build_parser(), _extra_parser(monkeypatch)) for a in p._actions
            if not isinstance(a, argparse._HelpAction)]


def _other_value(action) -> list:
    """Command-line words that give ``action`` a value other than its default."""
    flag = action.option_strings[0]
    if action.nargs == 0:
        return [flag]
    if action.choices:
        return [flag, next(c for c in action.choices if c != action.default)]
    word = {int: "7", float: "2.5"}.get(action.type, "x")
    return [flag, "1", "3"] if action.nargs == "+" else [flag, word]


@pytest.mark.parametrize("entry", sorted(PORT_PARSERS))
def test_every_jax_flag_accepted_with_its_default(entry, monkeypatch):
    port = {a.dest: a for a in PORT_PARSERS[entry]()._actions}
    jax_actions = _jax_actions(monkeypatch)
    assert len(jax_actions) == 34  # 30 of build_parser, 4 of parse_extra_args
    for a in jax_actions:
        assert a.dest in port, f"--{a.dest} is not a flag of the port's {entry}"
        b = port[a.dest]
        assert (b.option_strings, type(b), b.type, b.nargs, b.choices, b.default) == \
            (a.option_strings, type(a), a.type, a.nargs, a.choices, a.default), a.dest


@pytest.mark.parametrize("entry", sorted(PORT_PARSERS))
def test_a_jax_command_line_parses_to_jax_values(entry, monkeypatch):
    actions = _jax_actions(monkeypatch)
    argv = [w for a in actions for w in _other_value(a)]
    got = PORT_PARSERS[entry]().parse_args(argv)
    want, custom = j_opt.build_parser().parse_known_args(argv)
    extra = j_opt.parse_extra_args(custom)
    for a in actions:
        assert getattr(got, a.dest) == getattr(want, a.dest, getattr(extra, a.dest, None)), a.dest
        assert getattr(got, a.dest) != a.default, a.dest


@pytest.mark.parametrize("entry", sorted(PORT_PARSERS))
def test_unknown_flag_raises(entry):
    with pytest.raises(SystemExit):
        PORT_PARSERS[entry]().parse_args(["--cfg", "c.yaml", "--no_such_flag", "1"])


@pytest.mark.parametrize("entry,unread", [
    ("train", t_opt.NO_EFFECT + t_opt.SUBMIT_ONLY),
    ("submit_reload", t_opt.NO_EFFECT + t_opt.TRAIN_ONLY)])
def test_unread_flags_logged(entry, unread, caplog, monkeypatch):
    ap = PORT_PARSERS[entry]()
    args = ap.parse_args(["--cfg", "c.yaml", "--true_root", "--opg_batch_size", "64",
                          "--filter_unseen_obj_idxs", "2", "--test_freq", "1"])
    with caplog.at_level(logging.INFO, logger="artiboost_torch"):
        t_opt.log_unread(args, ap, unread)
    said = {r.getMessage().split()[0] for r in caplog.records
            if r.getMessage().endswith("accepted for the JAX command line; no effect")}
    given = {"--true_root", "--opg_batch_size", "--filter_unseen_obj_idxs", "--test_freq"}
    assert said == {f"--{n}" for n in unread} & given
    # a spawned rank other than the first says nothing
    caplog.clear()
    args.process_id = 1
    t_opt.log_unread(args, ap, unread)
    assert not caplog.records


def _epe_batch():
    """12 rows, object ids 1-5 (ids 1 and 3 among them), the last 3 rows
    masked out by SAMPLE_VALID, as a padded evaluation tail is."""
    rng = np.random.RandomState(7)
    B = 12
    targs = {"corners_3d": rng.randn(B, 8, 3).astype(np.float32) * 0.05,
             "joints_3d": rng.randn(B, 21, 3).astype(np.float32) * 0.05,
             "root_joint": rng.randn(B, 3).astype(np.float32) * 0.1
             + np.float32([0.0, 0.0, 0.6]),
             "obj_idx": np.int32([1, 3, 2, 5, 1, 4, 3, 2, 5, 1, 3, 4]),
             "sample_valid": np.float32([1] * 9 + [0] * 3)}
    preds = {"corners_3d_abs": targs["corners_3d"] + targs["root_joint"][:, None]
             + rng.randn(B, 8, 3).astype(np.float32) * 0.02,
             "joints_3d_abs": targs["joints_3d"] + targs["root_joint"][:, None]
             + rng.randn(B, 21, 3).astype(np.float32) * 0.02}
    return preds, targs


def test_filter_unseen_obj_idxs_against_jax():
    import jax.numpy as jnp
    import torch

    from artiboost_torch.metrics.evaluator import build_evaluator
    from artiboost_tpu.metrics.meanepe import Mean3DEPE as JMean3DEPE

    preds, targs = _epe_batch()
    cfg = {"TYPE": "Mean3DEPE", "VAL_KEYS": ["corners_3d_abs", "joints_3d_abs"],
           "MILLIMETERS": True, "FILTER_UNSEEN_OBJ_IDXS": [5]}
    arg = submit_reload.build_parser().parse_args(
        ["--cfg", "c.yaml", "--filter_unseen_obj_idxs", "1", "3"])
    assert arg.filter_unseen_obj_idxs == [1, 3]
    t_metric = build_evaluator([cfg], {}, device="cpu", ARG=arg).metrics_list[0]
    j_metric = JMean3DEPE(**{k: v for k, v in cfg.items() if k != "TYPE"},
                          ARG=argparse.Namespace(filter_unseen_obj_idxs=[1, 3]))
    t_metric.feed({k: torch.from_numpy(v) for k, v in preds.items()},
                  {k: torch.from_numpy(v) for k, v in targs.items()})
    j_metric.feed({k: jnp.asarray(v) for k, v in preds.items()},
                  {k: jnp.asarray(v) for k, v in targs.items()})
    got, want = t_metric.get_measures(), j_metric.get_measures()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)

    keep = (targs["sample_valid"] > 0) & ~np.isin(targs["obj_idx"], [1, 3])
    d = np.linalg.norm(preds["corners_3d_abs"].astype(np.float64)
                       - (targs["corners_3d"] + targs["root_joint"][:, None]), axis=2).mean(1)
    np.testing.assert_allclose(got["corners_3d_abs_mepe"], 1000 * d[keep].mean(), rtol=1e-6)
    assert 0 < keep.sum() < (targs["sample_valid"] > 0).sum()

    # without the command line (training), the config's list holds
    t_cfg = build_evaluator([cfg], {}, device="cpu").metrics_list[0]
    j_cfg = JMean3DEPE(**{k: v for k, v in cfg.items() if k != "TYPE"})
    assert t_cfg.filter_unseen_obj_idxs == list(j_cfg.filter_unseen_obj_idxs) == [5]
