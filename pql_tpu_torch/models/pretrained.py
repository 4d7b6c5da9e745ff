"""Local pretrained weights for the vision encoders (port of
pql_tpu/models/pretrained.py).

A user-supplied local file (``algo.encoder_weights=/path``) takes the place
of the reference's torchvision / torch-hub downloads. The file formats are
the JAX package's:

- ``.npz``: '/'-joined flax param paths → arrays (what the JAX package's
  ``save_params_npz`` writes, and this module's, from a port module);
- ``.pth`` / ``.pt``: a torch ``state_dict`` (or ``{"state_dict": ...}``);
  dot-joined keys become '/'-joined.

An orbax checkpoint directory, the JAX package's third form, needs JAX to
read; it is refused by name (write an ``.npz`` with the JAX package's
``save_params_npz`` instead).

``merge_pretrained`` merges by path suffix into a port module, in place,
through the module's flax-path view (``utils/convert.py::flax_param_paths``,
each key '/'-joined under ``params/``, each kernel in its flax layout), so
the same file matches the same leaves, transposed the same way, and gives
the same report (``loaded``, ``unmatched``, ``skipped``,
``shape_mismatch``) as the JAX package's ``merge_pretrained``: a 2-D torch
[out, in] weight is transposed to [in, out] and a 4-D [out, in, kh, kw]
relaid to [kh, kw, in, out] when only that fits.
``torchvision_resnet18_rename`` is the JAX package's map of a torchvision
``resnet18`` ``state_dict`` onto ``ResNet18Trunk``.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from pql_tpu_torch.utils.convert import flax_param_paths, kernel_to_flax, kernel_to_port


def _flax_view(module: torch.nn.Module) -> dict[str, tuple[str, torch.nn.Parameter]]:
    """'params/<flax path>' → (port name, parameter)."""
    params = dict(module.named_parameters())
    return {"params/" + "/".join(path): (name, params[name]) for name, path in flax_param_paths(module).items()}


def _flax_array(name: str, p: torch.Tensor) -> np.ndarray:
    a = p.detach().cpu().numpy()
    return kernel_to_flax(a) if name.endswith("weight") else a


def load_weight_file(path: str) -> dict[str, np.ndarray]:
    """Read a weight file into a flat {'/'-joined path: array} dict."""
    if os.path.isdir(path):
        raise ValueError(f"encoder_weights={path} is a directory (an orbax checkpoint); reading orbax needs JAX, "
                         "which the port does not use: write an .npz with the JAX package's save_params_npz")
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        return {k.replace(".", "/"): v.detach().numpy() for k, v in sd.items()}
    raise ValueError(f"Unsupported weight file: {path} (want .npz or .pth/.pt; an orbax directory needs JAX)")


def save_params_npz(path: str, module: torch.nn.Module) -> None:
    """A module's params as a flat .npz in the JAX package's layout."""
    np.savez(path, **{k: _flax_array(name, p) for k, (name, p) in _flax_view(module).items()})


@torch.no_grad()
def merge_pretrained(module: torch.nn.Module, path: str,
                     rename: Callable[[str], str | None] | dict[str, str] | None = None,
                     require_all: bool = False) -> dict[str, list[str]]:
    """Merge the weights of ``path`` into ``module`` in place by path-suffix
    match (see the module doc); returns the report."""
    file_weights = load_weight_file(path)
    skipped: list[str] = []
    if rename:
        ren = rename if callable(rename) else lambda k: rename.get(k, k)  # noqa: E731
        renamed = {}
        for k, v in file_weights.items():
            new_k = ren(k)
            if new_k is None:
                skipped.append(k)
            else:
                renamed[new_k] = v
        file_weights = renamed

    view = _flax_view(module)
    keys = list(view)
    report = {"loaded": [], "unmatched": [], "skipped": skipped, "shape_mismatch": []}
    for fkey, w in file_weights.items():
        hits = [k for k in keys if k == fkey or k.endswith("/" + fkey)]
        if not hits:
            report["unmatched"].append(fkey)
            continue
        for k in hits:
            name, p = view[k]
            shape = _flax_array(name, p).shape
            if w.shape == shape:
                flax = w
            elif w.ndim == 2 and w.T.shape == shape:
                flax = w.T  # torch [out, in] → [in, out]
            elif w.ndim == 4 and w.transpose(2, 3, 1, 0).shape == shape:
                flax = w.transpose(2, 3, 1, 0)  # torch Conv2d [out, in, kh, kw] → [kh, kw, in, out]
            else:
                report["shape_mismatch"].append(f"{fkey}: file {w.shape} vs param {shape}")
                continue
            port = kernel_to_port(flax) if name.endswith("weight") else flax
            p.copy_(torch.from_numpy(np.ascontiguousarray(port)).to(p.dtype))
            report["loaded"].append(k)
    if require_all and (report["unmatched"] or report["shape_mismatch"]):
        raise ValueError(f"Pretrained merge incomplete: {report}")
    return report


# ---------------------------------------------------------------------------
# the committed rename map for the weights the reference downloads
# ---------------------------------------------------------------------------

_TV_BLOCKS = {  # torchvision (layer, block) → flax auto-name in ResNet18Trunk
    ("layer1", "0"): "_BasicBlock_0",
    ("layer1", "1"): "_BasicBlock_1",
    ("layer2", "0"): "_BasicBlock_2",
    ("layer2", "1"): "_BasicBlock_3",
}


def torchvision_resnet18_rename(key: str) -> str | None:
    """A torchvision ``resnet18().state_dict()`` key ('/'-joined) as a
    ``ResNet18Trunk`` flax path, or None for keys without one: ``layer3``,
    ``layer4`` and ``fc`` (the reference cuts the model after ``layer2``) and
    BatchNorm running statistics (GroupNorm has none). BatchNorm affine
    lands on the GroupNorm's scale and bias."""
    parts = key.split("/")
    leaf = parts[-1]
    if parts[0] in ("layer3", "layer4", "fc"):
        return None
    if leaf in ("running_mean", "running_var", "num_batches_tracked"):
        return None
    affine = {"weight": "scale", "bias": "bias"}
    if parts[0] == "conv1":
        return "ResNet18Trunk_0/Conv_0/kernel"
    if parts[0] == "bn1":
        return f"ResNet18Trunk_0/GroupNorm_0/{affine[leaf]}"
    block = _TV_BLOCKS.get((parts[0], parts[1]) if len(parts) > 1 else None)
    if block is not None:
        sub = parts[2]
        if sub.startswith("conv"):
            return f"ResNet18Trunk_0/{block}/Conv_{int(sub[4:]) - 1}/kernel"
        if sub.startswith("bn"):
            return f"ResNet18Trunk_0/{block}/GroupNorm_{int(sub[2:]) - 1}/{affine[leaf]}"
        if sub == "downsample":  # 0 = 1×1 conv, 1 = its norm
            if parts[3] == "0":
                return f"ResNet18Trunk_0/{block}/Conv_2/kernel"
            return f"ResNet18Trunk_0/{block}/GroupNorm_2/{affine[leaf]}"
    return None
