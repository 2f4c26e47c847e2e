"""flax -> torch weight transplant: JAX parameter trees into the port.

The inverse of ``probunet_tpu/utils/transplant.py``: JAX params (nested
dicts of arrays, as ``model.init`` or an orbax checkpoint gives them) become
a port ``state_dict`` with the reference torch keys, converting layouts:

- conv weights   HWIO -> OIHW
- linear weights (in, out) -> (out, in)
- 1D params      copied as-is

:func:`flax_train_state_to_torch` carries a whole JAX ``TrainState``
(parameters, optax state, step) into the port's checkpoint payload, so a run
trained by the JAX package resumes in the port exactly where it stopped.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch


def _convert(arr) -> torch.Tensor:
    arr = np.array(arr, dtype=np.float32)  # a writable copy (device_get arrays are read-only)
    if arr.ndim == 4:      # conv HWIO -> OIHW
        arr = np.transpose(arr, (3, 2, 0, 1))
    elif arr.ndim == 2:    # linear (in, out) -> (out, in)
        arr = arr.T
    return torch.from_numpy(np.ascontiguousarray(arr))


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def flax_unet_to_torch(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``UNet`` params -> port ``UNet`` state_dict (keys prefixed by ``prefix``)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params).items():
        parts = path.split("/")
        head = parts[0]
        if head.startswith(("enc_", "dec_")):
            # flax "enc_64x64_block0/conv0/weight" -> torch "enc.64x64_block0.conv0.weight"
            side, name = head.split("_", 1)
            key = ".".join([side, name] + parts[1:])
        elif head in ("map_layer0", "map_layer1", "map_label", "map_augment", "out_norm",
                      "out_conv"):
            key = ".".join(parts)
        else:
            raise KeyError(f"unrecognized UNet param: {path}")
        out[prefix + key] = _convert(arr)
    return out


def flax_edm_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``EDMPrecond`` params ({"model": UNet params}) -> port
    ``EDMPrecond`` state_dict (keys under ``model.``)."""
    extra = set(params) - {"model"}
    if extra:
        raise KeyError(f"unrecognized EDMPrecond params: {sorted(extra)}")
    return flax_unet_to_torch(params["model"], prefix="model.")


def flax_probunet_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``ProbabilisticUNet`` params -> port ``ProbabilisticUNet`` state_dict."""
    out = flax_unet_to_torch(params["unet"], prefix="unet.")
    for net in ("prior", "posterior"):
        for path, arr in _flatten(params[net]).items():
            layer, leaf = path.split("/")
            if layer.startswith("enc_"):
                # encoder convs sit at nn.Sequential indices 0, 3, 6, 9
                key = f"{net}.encoder.{3 * int(layer[4:])}.{leaf}"
            else:  # conv_mu / conv_log_sigma
                key = f"{net}.{layer}.{leaf}"
            out[key] = _convert(arr)
    for path, arr in _flatten(params["fcomb"]).items():
        layer, leaf = path.split("/")
        # Fcomb convs sit at nn.Sequential indices 0, 2, 4
        out[f"fcomb.layers.{2 * int(layer[5:])}.{leaf}"] = _convert(arr)
    extra = set(params) - {"unet", "prior", "posterior", "fcomb"}
    if extra:
        raise KeyError(f"unrecognized ProbabilisticUNet params: {sorted(extra)}")
    return out


def _ordered(tree: Mapping, names: Sequence[str]) -> List[torch.Tensor]:
    """A JAX ProbabilisticUNet-shaped tree (params, or moments of them) as
    port tensors in the order of ``names``, the port's parameter names."""
    flat = flax_probunet_to_torch(tree)
    if set(flat) != set(names):
        raise KeyError(f"the tree's parameters differ from the port's: "
                       f"{sorted(set(flat) ^ set(names))[:5]}")
    return [flat[n] for n in names]


def _find_opt_nodes(node, found: dict) -> None:
    """Collect the optax state nodes the port's optimizer has counterparts
    for, by their fields (the namedtuple types are optax's): the Adam
    moments (``ScaleByAdamState``) and the accumulation window
    (``MultiStepsState``). Stateless links (``EmptyState``) hold nothing."""
    fields = getattr(node, "_fields", None)
    if fields is not None:
        if {"count", "mu", "nu"} <= set(fields):
            found.setdefault("adam", []).append(node)
        elif {"mini_step", "acc_grads", "inner_opt_state"} <= set(fields):
            found.setdefault("multi", []).append(node)
            _find_opt_nodes(node.inner_opt_state, found)
        elif fields:
            raise KeyError(f"no port counterpart for optax state {type(node).__name__}{fields}")
        return
    if not isinstance(node, (tuple, list)):
        raise KeyError(f"unrecognized optax state node {type(node).__name__}")
    for child in node:
        _find_opt_nodes(child, found)


def _first_leaf(tree: Mapping):
    """The first leaf of a nested mapping."""
    val = next(iter(tree.values()))
    return _first_leaf(val) if isinstance(val, Mapping) else val


def flax_opt_state_to_torch(opt_state, names: Sequence[str]) -> dict:
    """An optax state from ``probunet_tpu.train.state.make_optimizer`` (as
    numpy: ``jax.device_get`` of it) -> the port's ``Optimizer.state_dict``
    for the same options, its parameters ordered as ``names`` (the port
    model's ``named_parameters`` order). The layouts it reads:

    - adamw: ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``
      -> ``torch.optim.AdamW`` state: per parameter ``step`` = count,
      ``exp_avg`` = mu, ``exp_avg_sq`` = nu (adam likewise);
    - bf16-mu: ``(EmptyState(), ScaleByAdamState(count, mu bf16, nu fp32),
      ...)`` -> ``AdamWBf16State``: per parameter ``mu`` (bf16), ``nu``, the
      group's ``count``;
    - ``grad_clip``: an ``EmptyState`` in front;
    - ``accum`` > 1: ``MultiStepsState(mini_step, gradient_step,
      inner_opt_state, acc_grads, ...)`` -> ``mini_step`` and ``acc``.

    Moments and accumulated gradients change layout as the parameters do.
    The hyperparameters are not carried: the port's optimizer keeps those
    its config built."""
    found: dict = {}
    _find_opt_nodes(opt_state, found)
    adam, multi = found.get("adam", []), found.get("multi", [])
    if len(adam) > 1 or len(multi) > 1:
        raise KeyError("more than one Adam or MultiSteps state in the chain")
    state: Dict[int, dict] = {}
    group: dict = {"params": list(range(len(names)))}
    if adam:
        count = int(np.asarray(adam[0].count))
        mu, nu = _ordered(adam[0].mu, names), _ordered(adam[0].nu, names)
        bf16_mu = np.asarray(_first_leaf(adam[0].mu)).dtype.name == "bfloat16"
        for i, (m, v) in enumerate(zip(mu, nu)):
            if bf16_mu:
                state[i] = {"mu": m.to(torch.bfloat16), "nu": v}
            else:
                state[i] = {"step": torch.tensor(float(count)), "exp_avg": m, "exp_avg_sq": v}
        if bf16_mu:
            group["count"] = count
    acc: Optional[List[torch.Tensor]] = None
    mini_step = 0
    if multi:
        mini_step = int(np.asarray(multi[0].mini_step))
        acc = _ordered(multi[0].acc_grads, names)
    return {"inner": {"state": state, "param_groups": [group]}, "mini_step": mini_step,
            "acc": acc}


def flax_train_state_to_torch(state, names: Sequence[str]) -> dict:
    """A JAX ``TrainState(params, opt_state, step)`` (as numpy) -> the
    port's checkpoint payload ``{"params", "optimizer", "step"}``, which
    ``train.checkpoint.load_payload`` loads into a port ``TrainState`` whose
    model's parameter names are ``names``."""
    params, opt_state, step = state
    return {"params": flax_probunet_to_torch(params),
            "optimizer": flax_opt_state_to_torch(opt_state, names),
            "step": int(np.asarray(step))}
