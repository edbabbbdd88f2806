"""The port's checkpoints and trainer against the JAX package's.

`repro_torch.runtime.checkpoint` writes the reference's format (one
``.npy`` of raw bytes per leaf, ``manifest.json``, an atomic rename,
``keep_last``), so each package reads the other's checkpoints, bf16
leaves included, bit for bit.  The port's `Trainer` resumes after an
injected failure to the same bits as an uninterrupted run (on the CPU
here; on the card in ``chip_smoke.py``'s train phase), and resumes from
the reference's ``init_state`` written through the reference's ``save``:
its steps then match the reference's on the same batches within the f32
tolerances of tests/test_torch_train.py.
"""
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.runtime import checkpoint as ref_ckpt
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import init_state as jax_init_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.models.bridge import tree_to_numpy
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.training import OptimizerConfig, TrainConfig, Trainer

ARCH = "internlm2-1.8b"


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _tree_equal(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def _tree():
    return {"a": {"b": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
            "c": torch.tensor(3.5),
            "d": {"e": {"f": torch.tensor([1.0, -2.5, 3e-3, 7.0],
                                          dtype=torch.bfloat16)}},
            "g": torch.ones((2, 2), dtype=torch.bool)}


def test_save_load_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 7, tree, metadata={"note": "x"})
    loaded, manifest = ckpt.load(str(tmp_path), 7)
    assert manifest["step"] == 7 and manifest["metadata"]["note"] == "x"
    assert _tree_equal(tree, loaded)
    assert manifest["leaves"]["d/e/f"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["c"]["shape"] == []


def test_keep_last_gc(tmp_path):
    tree = {"x": torch.zeros((2,))}
    for step in range(6):
        ckpt.save(str(tmp_path), step, tree, keep_last=3)
    assert ckpt.available_steps(str(tmp_path)) == [3, 4, 5]
    assert ckpt.load_latest(str(tmp_path))[0] == 5


def test_no_tmp_dirs_left_behind(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros((2,))})
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    assert ckpt.load_latest(str(tmp_path / "none")) is None


def test_async_save_snapshots_before_returning(tmp_path):
    x = torch.arange(3.0)
    t = ckpt.save_async(str(tmp_path), 2, {"x": x})
    x.add_(100.0)                  # training goes on during the write
    t.join(timeout=30)
    assert not t.is_alive()
    loaded, _ = ckpt.load(str(tmp_path), 2)
    assert torch.equal(loaded["x"], torch.arange(3.0))


def test_reference_reads_the_ports_checkpoint(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 3, tree, metadata={"by": "port"})
    loaded, manifest = ref_ckpt.load(str(tmp_path), 3)
    assert manifest["metadata"] == {"by": "port"}
    f = loaded["d"]["e"]["f"]
    assert f.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(f.astype(np.float32),
                                  tree["d"]["e"]["f"].float().numpy())
    np.testing.assert_array_equal(loaded["a"]["b"], tree["a"]["b"].numpy())
    assert loaded["c"].shape == () and float(loaded["c"]) == 3.5
    np.testing.assert_array_equal(loaded["g"], np.ones((2, 2), bool))


def test_port_reads_the_references_checkpoint(tmp_path):
    tree = {"a": {"b": jnp.arange(6).reshape(2, 3)},
            "c": jnp.float32(3.5),
            "d": {"e": {"f": jnp.array([1.0, -2.5, 3e-3, 7.0],
                                       jnp.bfloat16)}}}
    ref_ckpt.save(str(tmp_path), 4, tree)
    loaded, manifest = ckpt.load(str(tmp_path), 4)
    assert manifest["step"] == 4
    f = loaded["d"]["e"]["f"]
    assert f.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        f.view(torch.int16).numpy(),
        np.asarray(tree["d"]["e"]["f"]).view(np.int16))
    np.testing.assert_array_equal(loaded["a"]["b"].numpy(),
                                  np.asarray(tree["a"]["b"]))
    assert loaded["c"].shape == () and float(loaded["c"]) == 3.5


def _trainer(d, fail_at=None):
    tc = TrainConfig(optimizer=OptimizerConfig(learning_rate=1e-3),
                     compute_dtype="float32", checkpoint_dir=str(d),
                     checkpoint_every=4, log_every=100)
    return Trainer(get_smoke_config(ARCH), tc, batch_size=2, seq_len=16,
                   seed=0, fail_at_step=fail_at, device="cpu")


def test_crash_resume_is_bitwise_identical(tmp_path):
    d1, d2 = tmp_path / "uninterrupted", tmp_path / "crashed"
    ref = _trainer(d1).run(10)
    with pytest.raises(RuntimeError, match="injected failure"):
        _trainer(d2, fail_at=6).run(10)
    # the step-4 checkpoint may still be in flight at the crash
    deadline = time.time() + 30
    while time.time() < deadline and ckpt.available_steps(str(d2)) != [4]:
        time.sleep(0.2)
    assert ckpt.available_steps(str(d2)) == [4]     # survived the crash
    resumed = _trainer(d2).run(10)                   # auto-resume from 4
    assert int(resumed["step"]) == 10
    assert _tree_equal(ref["params"], resumed["params"])
    assert _tree_equal(ref["opt"], resumed["opt"])
    assert ckpt.available_steps(str(d2)) == [4, 8, 10]   # keep_last 3


def test_trainer_resumes_from_the_references_init_state(tmp_path):
    """The reference's ``init_state`` through the reference's ``save`` at
    step 0: the port's trainer restores it exactly (int32 step
    included), and its three steps on its own batches match the
    reference's train step on the same batches."""
    jcfg = jax_smoke_config(ARCH)
    jtc = JaxTrainConfig(optimizer=JaxOptimizerConfig(learning_rate=1e-3),
                         compute_dtype="float32")
    jstate = jax_init_state(jcfg, jtc, 0)
    ref_ckpt.save(str(tmp_path), 0, jstate, metadata={"arch": ARCH})
    trainer = _trainer(tmp_path)
    restored = trainer.restore_or_init()
    for (path, got), (_, want) in zip(
            _leaves(tree_to_numpy(restored)),
            _leaves(jax.tree.map(np.asarray, jstate))):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want)
    state = trainer.run(3)
    jstep = jax.jit(jax_make_train_step(jcfg, jtc))
    for step in range(3):
        batch = {k: jnp.asarray(v.numpy())
                 for k, v in trainer.data_for_step(step).items()}
        jstate, _ = jstep(jstate, batch)
    for (path, got), (_, want) in zip(
            _leaves(tree_to_numpy(state)),
            _leaves(jax.tree.map(np.asarray, jstate))):
        d = float(np.linalg.norm(np.float32(got) - np.float32(want)))
        assert d <= 1e-4 * float(np.linalg.norm(np.float32(want))) + 1e-7, \
            path
    assert ckpt.available_steps(str(tmp_path)) == [0, 3]
