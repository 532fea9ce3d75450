"""Carry state across from the JAX package: numpy arrays in, the port's
objects out, on a given device. Imports nothing of `repro`; the caller
turns the JAX package's arrays into numpy (`np.asarray`), or reads them from
a checkpoint the JAX package wrote (`repro_torch.ckpt`)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.increm import Provenance
from repro_torch.data.synth import ChefDataset


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def _i64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int64), device=device)


def head_from_numpy(w, device="cpu") -> torch.Tensor:
    """Head weights [C, d+1] as float32."""
    return _f32(w, device)


def dataset_from_numpy(*, name, X, y_prob, y_weight, cleaned, y_true, human_labels, X_val,
                       y_val, X_test, y_test, n_classes, device="cpu") -> ChefDataset:
    """A `ChefDataset` from every field of the JAX package's dataset."""
    return ChefDataset(
        name=str(name), X=_f32(X, device), y_prob=_f32(y_prob, device),
        y_weight=_f32(y_weight, device),
        cleaned=torch.as_tensor(np.array(cleaned, bool), device=device),
        y_true=_i64(y_true, device), human_labels=_i64(human_labels, device),
        X_val=_f32(X_val, device), y_val=_f32(y_val, device), X_test=_f32(X_test, device),
        y_test=_i64(y_test, device), n_classes=int(n_classes))


def provenance_from_numpy(w0, p0, hnorm, device="cpu") -> Provenance:
    """Increm-INFL provenance (w0 [C, d+1], p0 [N, C], hnorm [N])."""
    return Provenance(_f32(w0, device), _f32(p0, device), _f32(hnorm, device))


def schedule_from_numpy(sched, device="cpu") -> torch.Tensor:
    """A batch schedule [T, bs] as int64 row ids."""
    return _i64(sched, device)


def trajectory_from_numpy(ws, gs, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """A DeltaGrad trajectory (ws, gs), each [T, C, d+1], as float32."""
    return _f32(ws, device), _f32(gs, device)


def seed_from_key_slot(key) -> int:
    """The port's int seed from a session checkpoint's key slot: the port
    stores its seed there as a scalar; the JAX package stores
    `jax.random.key_data` of its key, two uint32 words [hi, lo] that for a
    key made by `jax.random.key(seed)` are the seed's high and low halves."""
    a = np.asarray(key)
    if a.shape == (2,):
        return (int(a[0]) << 32) | int(a[1])
    return int(a)


# the leaves of a session's state_tree(), as both packages write them:
# name -> dtype of the port's tensor (None: kept as numpy)
SESSION_STATE = {
    "w": torch.float32, "sched": torch.int64, "traj_ws": torch.float32,
    "traj_gs": torch.float32, "prov_w0": torch.float32, "prov_p0": torch.float32,
    "prov_hnorm": torch.float32, "y_prob": torch.float32, "y_weight": torch.float32,
    "cleaned": torch.bool, "has_traj": None, "has_prov": None, "key": None, "round": None,
    "spent": None, "terminated": None, "history": None,
}


def state_from_numpy(state: dict, device="cpu") -> dict:
    """A session's `state_tree()` with numpy leaves (the port's or the JAX
    package's, as `restore_checkpoint` reads them) -> the same dict with the
    tensor leaves as the port's tensors on `device`, the key slot as the
    port's int seed (`seed_from_key_slot`) and the counters and history as
    numpy."""
    out = {}
    for name, dtype in SESSION_STATE.items():
        a = state[name]
        if name == "key":
            out[name] = seed_from_key_slot(a)
        elif dtype is None:
            out[name] = np.asarray(a)
        else:
            out[name] = torch.as_tensor(np.array(a), device=device).to(dtype)
    return out


def model_params_from_numpy(cfg, tree, device="cpu") -> dict:
    """The JAX package's model parameters (its `Model.init` pytree with numpy
    leaves: `embed.tok`, the stacked `blocks[j]` leaves `attn.wq/wk/wv/wo`,
    `mlp.wi/wg/wo`, the norms where parametric, `tail`, `final_norm`) -> the
    port's parameter tree on `device`. Raises unless every name and shape is
    the one the port's `init_params` makes for `cfg`."""
    from repro_torch.models import transformer as T

    want = T.init_params(cfg, lambda shape, axes=None, fan_in=None, mode="normal":
                         torch.empty(shape, device="meta"))

    def walk(w, t, path):
        if isinstance(w, dict):
            if not isinstance(t, dict) or set(t) != set(w):
                raise ValueError(f"params{path}: keys {sorted(t) if isinstance(t, dict) else t!r}"
                                 f", want {sorted(w)}")
            return {k: walk(w[k], t[k], f"{path}.{k}") for k in w}
        if isinstance(w, tuple):
            if len(t) != len(w):
                raise ValueError(f"params{path}: {len(t)} entries, want {len(w)}")
            return tuple(walk(a, b, f"{path}[{i}]") for i, (a, b) in enumerate(zip(w, t)))
        leaf = _f32(t, device)
        if tuple(leaf.shape) != tuple(w.shape):
            raise ValueError(f"params{path}: shape {tuple(leaf.shape)}, want {tuple(w.shape)}")
        return leaf

    return walk(want, tree, "")
