"""``submit_reload`` on ``config_eval/eval_dexycb_clasbased_sym_artiboost.yaml``
(HybridBaseline, ``SymCornerLoss``, BOP's AR; ``pred_dexycb.json``) against
JAX's ``train/submit_reload.py`` ``main_worker`` on a DexYCB s0 test split
on disk, from the same weights; the cut, the fixture and the bounds are
``tests/test_torch_submit_configs.py``'s (a file of its own so that the
suite's workers share the two JAX runs)."""

from tests.test_torch_submit_configs import against_jax, write_dexycb


def test_dexycb_against_jax(tmp_path, monkeypatch):
    write_dexycb(tmp_path)
    against_jax("eval_dexycb_clasbased_sym_artiboost", tmp_path, tmp_path, monkeypatch)
