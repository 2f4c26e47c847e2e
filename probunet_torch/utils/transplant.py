"""flax -> torch weight transplant: JAX parameter trees into the port.

The inverse of ``probunet_tpu/utils/transplant.py``: JAX params (nested
dicts of arrays, as ``model.init`` or an orbax checkpoint gives them) become
a port ``state_dict`` with the reference torch keys, converting layouts:

- conv weights   HWIO -> OIHW
- linear weights (in, out) -> (out, in)
- 1D params      copied as-is
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _convert(arr) -> torch.Tensor:
    arr = np.asarray(arr, dtype=np.float32)
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
        elif head in ("map_layer0", "map_layer1", "out_norm", "out_conv"):
            key = ".".join(parts)
        else:
            raise KeyError(f"unrecognized UNet param: {path}")
        out[prefix + key] = _convert(arr)
    return out


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
