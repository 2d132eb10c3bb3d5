"""The port's ``Trainer`` against the JAX package's on the families that
PR 23's tests do not train: histories and checkpoints.

Apart from ``tests/test_torch_train.py`` (whose helpers it uses) so that
the two run on two test workers.  Held here, from the reference's init
and the same synthetic data:

- a 20-step history within rtol 1e-4 of the reference ``Trainer``'s for a
  Mamba (falcon-mamba-7b), a MoE (qwen2-moe-a2.7b) and the enc-dec family
  (seamless-m4t-large-v2), each falling;
- checkpoints both ways for jamba-1.5-large-398b (with f32 moments: the
  reference's restore cannot read its own bf16 leaves, ``astype`` has no
  cast from ``|V2``) and seamless-m4t-large-v2: the reference's step-10
  checkpoint resumed by the port, and the port's by the reference, each
  continuing the reference's loss curve for 5 steps at rtol 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import restore_checkpoint
from test_torch_train import (_from_reference_init,  # noqa: F401
                              _one_torch_thread, _trainer)

CROSSING = {"jamba-1.5-large-398b": (("adam_dtype", "float32"),),
            "seamless-m4t-large-v2": ()}


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "qwen2-moe-a2.7b",
                                  "seamless-m4t-large-v2"])
def test_family_trainer_history_matches_reference(name):
    """A Mamba, a MoE and the enc-dec family: 20 steps from the reference's
    init within rtol 1e-4 of the reference ``Trainer``'s losses."""
    jtr = _trainer(cls=JTrainer, name=name)
    jtr.run(20)
    tr = _trainer(name=name)
    tr.run(20, state=_from_reference_init(tr, name))
    np.testing.assert_allclose(tr.history, jtr.history, rtol=1e-4)
    assert tr.history[-1] < tr.history[0]


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """{arch: (the reference Trainer's 15 losses, its checkpoint directory:
    steps 5, 10 and 15)} for ``CROSSING``."""
    out = {}
    for name, over in CROSSING.items():
        ckpt = tmp_path_factory.mktemp(name)
        jtr = _trainer(ckpt, cls=JTrainer, name=name, over=over)
        jtr.run(15)
        out[name] = (jtr.history, ckpt)
    return out


@pytest.mark.parametrize("name", sorted(CROSSING))
def test_family_checkpoints_cross_both_ways(tmp_path, name, reference_runs):
    over = CROSSING[name]
    want, ref_dir = reference_runs[name]
    tr = _trainer(name=name, over=over)
    state, extra = restore_checkpoint(str(ref_dir / "step_10.npz"),
                                      tr.init_state())
    tr.data.load_state_dict(extra["data"])
    assert state.step == 10 and state.opt.count == 10 and tr.data.step == 10
    tr.run(5, state=state)
    np.testing.assert_allclose(tr.history, want[10:15], rtol=1e-4)

    tr = _trainer(tmp_path, name=name, over=over)
    tr.run(10, state=_from_reference_init(tr, name, over))
    np.testing.assert_allclose(tr.history, want[:10], rtol=1e-4)
    jtr = _trainer(tmp_path, cls=JTrainer, name=name, over=over)
    state = jtr.resume_or_init()
    assert int(state.step) == 10 and jtr.data.step == 10
    jtr.run(5, state=state)
    np.testing.assert_allclose(jtr.history, want[10:15], rtol=1e-4)
