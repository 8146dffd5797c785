"""The reference checkpoint forms the port's ``CheckpointManager.restore``
takes (``wmfml_tpu/ckpt/torch_import.py:619-689``), on files the tests
write themselves: MMAML's combined dict (also read by the JAX package's
loader, to the same weights), a file torch's default tensors-only load
refuses but whose pickle names only allowlisted globals, crafted pickles
naming ``os.system`` through each opcode that can name a global and in a
legacy file's later pickle (refused, never run), ``{"state_dict": sd}``,
and a reference file under ``learn_step_size`` (step sizes at
``update_lr``, with a warning).
"""

import collections
import logging
import os
import pickle
import struct
import zipfile

import numpy as np
import pytest
import torch

from wmfml_tpu_torch.ckpt.checkpoint import CheckpointManager
from wmfml_tpu_torch.models.maml import MAMLRegressor
from wmfml_tpu_torch.models.mmaml_nets import MMAMLBundle
from torch_port_common import one_torch_thread  # noqa: F401


def _bundle(seed):
    return MMAMLBundle(output_dim=2, num_channels=4,
                       embedding_dims=(8, 16, 32, 64), hidden_size=16,
                       generator=torch.Generator().manual_seed(seed))


def _combined(model, extra=None):
    """The reference's MMAML combined dict of ``model``
    (``trainer/meta_learner_reg.py:218-227``): each net's state_dict, the
    gated net's BN running statistics among them, and two Adam states."""
    sd = model.state_dict()
    gated = {k[len("model."):]: v for k, v in sd.items()
             if k.startswith("model.")}
    for i in range(1, 5):
        c = gated[f"features.layer{i}_conv.bias"].shape[0]
        gated[f"features.layer{i}_bn.running_mean"] = torch.zeros(c)
        gated[f"features.layer{i}_bn.running_var"] = torch.ones(c)
        gated[f"features.layer{i}_bn.num_batches_tracked"] = torch.tensor(7)
    opts = []
    for net in (model.model, model.embedding_model):
        opt = torch.optim.Adam(net.parameters())
        for p in net.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        opts.append(opt.state_dict())
        net.zero_grad(set_to_none=True)
    return {"model_state_dict": gated,
            "embedding_model_state_dict": {
                k[len("embedding_model."):]: v for k, v in sd.items()
                if k.startswith("embedding_model.")},
            "optimizers": opts if extra is None else opts + [extra]}


def _assert_same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def warnings():
    handler, logger = _Records(), logging.getLogger("wmfml_tpu_torch")
    logger.addHandler(handler)
    yield handler.messages
    logger.removeHandler(handler)


def test_mmaml_combined_dict_restores_as_jax_reads_it(tmp_path):
    from wmfml_tpu.ckpt.torch_import import load_torch_variables
    from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables

    saved, path = _bundle(1), str(tmp_path / "mmaml.pt")
    torch.save(_combined(saved), path)
    restored = _bundle(2)
    assert CheckpointManager(str(tmp_path)).restore(path, restored) == 0
    _assert_same_weights(restored, saved)

    class Cfg:
        method, n_hidden_units_r, img_agg, agg_mode = (
            "MMAMLShapeNet1D", [], None, None)

    carried = load_jax_variables(_bundle(3), load_torch_variables(Cfg, path))
    _assert_same_weights(carried, saved)


@pytest.mark.parametrize("extra", ["defaultdict", "numpy"])
def test_refused_file_with_allowlisted_globals_loads(tmp_path, extra):
    """A ``defaultdict`` or numpy values in the optimizer list: torch's
    default tensors-only load refuses the file; their globals are on the
    port's list, so it loads."""
    value = (collections.defaultdict(list) if extra == "defaultdict" else
             {"lr": np.float64(1e-3), "betas": np.array([0.9, 0.999])})
    saved, path = _bundle(4), str(tmp_path / "mmaml.pt")
    torch.save(_combined(saved, value), path)
    with pytest.raises(pickle.UnpicklingError):
        torch.load(path, weights_only=True)
    restored = _bundle(5)
    CheckpointManager(str(tmp_path)).restore(path, restored)
    _assert_same_weights(restored, saved)


class _Evil:
    """Unpickling this would run a shell command that makes a file."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (os.system, (f"touch {self.marker}",))


def _inst_pickle(marker):
    """``INST``: the module and name ride in the opcode's argument."""
    cmd = f"touch {marker}".encode()
    return (b"(X" + struct.pack("<I", len(cmd)) + cmd + b"ios\nsystem\n.")


def _legacy_file(payload_pickle):
    """A legacy torch file: magic number, protocol version and sys_info,
    each a pickle of its own, then the payload's pickle."""
    head = (0x1950A86A20F9469CFC6C, 1001,
            {"protocol_version": 1001, "little_endian": True,
             "type_sizes": {"short": 2, "int": 4, "long": 8}})
    return b"".join(pickle.dumps(h, protocol=2) for h in head) + payload_pickle


@pytest.mark.parametrize("form", ["zip", "legacy", "stack_global", "inst",
                                  "legacy_later_pickle"])
def test_crafted_pickle_is_refused_without_running_it(tmp_path, form):
    marker, path = tmp_path / "ran", str(tmp_path / "evil.pt")
    payload = {"model_state_dict": _Evil(marker)}
    data = {"zip": None,
            "legacy": pickle.dumps(payload, protocol=2),
            "stack_global": pickle.dumps(payload, protocol=4),
            "inst": _inst_pickle(marker),
            "legacy_later_pickle": _legacy_file(
                pickle.dumps(payload, protocol=2))}[form]
    if form == "zip":
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("archive/data.pkl", pickle.dumps(payload, protocol=2))
            zf.writestr("archive/byteorder", "little")
            zf.writestr("archive/version", "3\n")
    else:
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(RuntimeError, match="refusing to unpickle") as err:
        CheckpointManager(str(tmp_path)).restore(path, _bundle(6))
    if form in ("zip", "legacy", "legacy_later_pickle"):   # GLOBAL opcode
        assert "system" in str(err.value)
    assert not marker.exists()


def _maml(seed, learn=False, per_param=False):
    return MAMLRegressor(dim_w=36, dim_hidden=8, img_size=(32, 32, 1),
                         learn_step_size=learn,
                         per_param_step_size=per_param, update_lr=0.1,
                         generator=torch.Generator().manual_seed(seed))


def test_state_dict_form_restores(tmp_path):
    saved, path = _maml(1), str(tmp_path / "ref.pt")
    torch.save({"state_dict": saved.state_dict()}, path)
    restored = _maml(2)
    assert CheckpointManager(str(tmp_path)).restore(path, restored) == 0
    _assert_same_weights(restored, saved)
    # an unknown key still fails the strict load
    torch.save({"state_dict": {**saved.state_dict(), "extra.weight":
                               torch.zeros(1)}}, path)
    with pytest.raises(RuntimeError, match="extra.weight"):
        CheckpointManager(str(tmp_path)).restore(path, _maml(3))


@pytest.mark.parametrize("per_param", [False, True])
def test_reference_file_under_learn_step_size(tmp_path, per_param, warnings):
    """A reference ``.pt`` carries no inner step sizes: they start at
    ``update_lr``, with a warning, and every other weight is the file's."""
    saved, path = _maml(1), str(tmp_path / "ref.pt")
    torch.save(saved.state_dict(), path)
    restored = _maml(2, learn=True, per_param=per_param)
    CheckpointManager(str(tmp_path)).restore(path, restored)
    sd = restored.state_dict()
    steps = {k: v for k, v in sd.items() if k.startswith("step_size")}
    assert len(steps) == (18 if per_param else 1)
    assert all(torch.equal(v, torch.tensor(0.1)) for v in steps.values())
    for k, v in saved.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert any("starts them at update_lr" in m for m in warnings), warnings
