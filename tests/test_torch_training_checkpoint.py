"""The port's checkpoints and restarts (``training/checkpoint.py``,
``Trainer``) against the JAX package's, on the CPU.

Both sides hold the same weights: the reference's ``init`` params cast to
fp32 (this image's CPU jax cannot run the bf16 LM path), carried over with
each family's ``params_from_arrays``; the batches are the step-keyed
pipeline's, from its seed.  The reference's functions are compiled with
XLA's excess precision off (``_xla_strict.strict_jit``), so that the
encoder-decoder's bf16 encoder rounds where its code says, as the port's
does.  The shared setup is ``tests/_torch_training_common.py``.

* restart bit for bit, async ≡ sync checkpoints, CRC corruption caught;
* checkpoints readable in both directions between the two packages.
"""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import ShapeConfig as RefShape  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.training import checkpoint as ref_ckpt  # noqa: E402
from repro.training.trainer import Trainer as RefTrainer  # noqa: E402
from repro.training.trainer import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.param_tree import flatten  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from _torch_training_common import (  # noqa: E402
    _port_trainer,
    _ref_flat,
    _ref_init_arrays,
    _ref_trainer,
    _stacked,
    _TrainerFrom,
)


class TestRestartDeterminism:
    def test_resume_bitwise_identical(self, tmp_path):
        """Uninterrupted run ≡ crash after step 4 + restart (bf16 params, the
        port's own init): params bit for bit, losses continue."""
        full = _port_trainer(str(tmp_path / "full"), 6, ckpt_every=2)
        hist_full = full.fit()
        crash = str(tmp_path / "crash")
        _port_trainer(crash, 6, ckpt_every=2, stop_after=4).fit()
        resumed = _port_trainer(crash, 6, ckpt_every=2)
        hist_res = resumed.fit(resume=True)
        a, b = dict(full.params.named_parameters()), dict(
            resumed.params.named_parameters())
        assert a[next(iter(a))].dtype == torch.bfloat16
        for name in a:
            assert torch.equal(a[name], b[name]), name
        assert hist_res["step"][0] == 4
        np.testing.assert_allclose(hist_full["loss"][4:], hist_res["loss"],
                                   rtol=1e-6)


class TestCheckpoint:
    def test_roundtrip_and_keeps_latest(self, tmp_path):
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "b": {"c": torch.ones((2,), dtype=torch.int32),
                      "d": torch.arange(6.0).to(torch.bfloat16)}}
        for s in (1, 2, 3):
            ckpt.save(str(tmp_path), s, tree)
        assert ckpt.latest_steps(str(tmp_path)) == [1, 2, 3]
        like = {"a": torch.zeros(3, 4),
                "b": {"c": torch.zeros(2, dtype=torch.int32),
                      "d": torch.zeros(6, dtype=torch.bfloat16)}}
        restored, step = ckpt.restore(str(tmp_path), like)
        assert step == 3
        assert torch.equal(like["a"], tree["a"])
        assert torch.equal(like["b"]["c"], tree["b"]["c"])
        assert torch.equal(like["b"]["d"], tree["b"]["d"])
        assert restored["a"] is like["a"]

    def test_crc_detects_corruption(self, tmp_path):
        tree = {"w": torch.ones((8, 8))}
        path = ckpt.save(str(tmp_path), 1, tree)
        for name in os.listdir(path):
            if name.endswith(".npy"):
                arr = np.load(os.path.join(path, name))
                arr[0] += 1
                np.save(os.path.join(path, name), arr)
        with pytest.raises(IOError):
            ckpt.restore(str(tmp_path), tree)

    def test_async_equals_sync(self, tmp_path):
        t_sync = _port_trainer(str(tmp_path / "s"), 4, ckpt_every=2)
        t_sync.fit()
        t_async = _port_trainer(str(tmp_path / "a"), 4, ckpt_every=2,
                                async_ckpt=True)
        t_async.fit()
        for step in (2, 4):
            a, _ = ckpt.load_arrays(str(tmp_path / "s"), step)
            b, _ = ckpt.load_arrays(str(tmp_path / "a"), step)
            fa, fb = flatten(a), flatten(b)
            assert set(fa) == set(fb)
            for k in fa:
                np.testing.assert_array_equal(fa[k], fb[k])

    def test_reference_checkpoint_restores_in_the_port(self, tmp_path):
        """The reference's trainer writes; the port reads the params through
        ``params_from_arrays`` and restores the whole state in place."""
        ref = _ref_trainer(str(tmp_path), 2, ckpt_every=2)
        ref.fit()
        arrays, step = ckpt.load_arrays(str(tmp_path))
        assert step == 2
        cfg = get_config("llama3.2-1b").reduced()
        model = transformer.params_from_arrays(cfg, arrays["params"],
                                               dtype=torch.float32)
        want = _ref_flat(ref.params)
        got = _stacked(transformer.ref_leaves(model))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        port = _port_trainer(None, 2)
        params, opt_state, _ = port.init_state()
        ckpt.restore(str(tmp_path), port.state_tree(params, opt_state))
        ref_m = _ref_flat(ref.opt_state["m"])
        for k, leaf in opt_state["m"].items():
            np.testing.assert_array_equal(leaf.stacked().numpy(), ref_m[k])
        assert int(opt_state["step"]) == 2

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_port_checkpoint_restores_in_the_reference(self, tmp_path, dtype):
        if dtype == "float32":
            port = _port_trainer(str(tmp_path), 2, cls=_TrainerFrom,
                                 ckpt_every=2)
            port.arrays = _ref_init_arrays()
            ref = _ref_trainer(None, 2)
        else:
            port = _port_trainer(str(tmp_path), 2, ckpt_every=2)
            ref = RefTrainer(ref_get_config("llama3.2-1b").reduced(),
                             RefShape("t", 16, 4, "train"),
                             RefTrainerConfig(total_steps=2))
        port.fit()
        params, opt_state, _ = ref.init_state()
        state, step = ref_ckpt.restore(str(tmp_path),
                                       {"params": params, "opt": opt_state})
        assert step == 2
        leaves = transformer.ref_leaves(port.params)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]:
            key = tuple(str(p.key) for p in path)
            assert str(leaf.dtype) == dtype
            np.testing.assert_array_equal(
                np.asarray(leaf, np.float32),
                leaves[key].stacked().detach().float().numpy())
        want_v = _stacked(port.opt_state["v"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["opt"]["v"])[0]:
            key = tuple(str(p.key) for p in path)
            np.testing.assert_array_equal(np.asarray(leaf), want_v[key])
        assert int(state["opt"]["step"]) == 2
