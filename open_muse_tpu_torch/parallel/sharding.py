"""Parameter partition rules: the JAX package's param-path regex ->
``PartitionSpec`` rules, read over the port's ``state_dict`` names.

Counterpart of ``open_muse_tpu/parallel/sharding.py``.  The rules are the
JAX ones, written over flax paths and JAX layouts; a port parameter is
matched by its flax path (``optimizers.flax_param_name``, the converter's
name map) and its spec is carried to the torch layout by the converter's
axis map (``core.convert.jax_layout``): a Dense kernel is (in, out) in JAX
and a torch ``Linear.weight`` (out, in), so ``P('fsdp', 'tp')`` on
``attention.query.kernel`` is ``('tp', 'fsdp')`` on the torch weight, and a
convolution's HWIO spec is read in OIHW.

``shard_params`` applies the fsdp axis with FSDP2 ``fully_shard`` over the
mesh's fsdp dim: every parameter is stored as shards of the dim its rule
names for fsdp (dim 0 where the rule names none: FSDP2 shards every
parameter it manages), and the root module's forward all-gathers whole
weights first, so the kernels run on gathered tensors.  The tp axis
(tensor-parallel weights) is not applied yet: ``make_param_shardings``
gives each parameter's tp dim, and ``shard_params`` raises for tp > 1
(every config sets ``tp: 1``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from torch import nn

from ..core.convert import jax_layout

__all__ = ["DEFAULT_RULES", "spec_for_path", "torch_spec", "make_param_shardings",
           "shard_params"]

Spec = Tuple[Optional[str], ...]  # one mesh axis name (or None) a dim

# (path regex, spec over the JAX layout's dims) -- first match wins; paths
# are '.'-joined flax param paths, e.g. "transformer_layers_3.attention.query.kernel".
# TP splits attention heads / MLP columns; FSDP shards the complementary dim.
DEFAULT_RULES: List[Tuple[str, Spec]] = [
    # attention projections: (in, out)
    (r"\b(attention|crossattention)\.(query|key|value)\.kernel$", ("fsdp", "tp")),
    (r"\b(attention|crossattention)\.out\.kernel$", ("tp", "fsdp")),
    (r"\bself_attn\.(q_proj|k_proj|v_proj)\.kernel$", ("fsdp", "tp")),
    (r"\bself_attn\.out_proj\.kernel$", ("tp", "fsdp")),
    # GLU / MLP
    (r"\bffn\.(wi_0|wi_1)\.kernel$", ("fsdp", "tp")),
    (r"\bffn\.wo\.kernel$", ("tp", "fsdp")),
    (r"\b(fc1)\.kernel$", ("fsdp", "tp")),
    (r"\b(fc2)\.kernel$", ("tp", "fsdp")),
    # big embeddings / output head: shard vocab over fsdp
    (r"\bembeddings?\.embedding$", ("fsdp", None)),
    (r"\bword_embeddings\.embedding$", ("fsdp", None)),
    (r"\bmlm_layer\.conv2\.kernel$", (None, None, "fsdp", "tp")),
    # AdaLN mappers and other 2D kernels: fsdp on the input dim
    (r"\bmapper\.kernel$", ("fsdp", None)),
    (r"\b(project_to_hidden|project_from_hidden|encoder_proj|cond_embed_\d)\.kernel$",
     ("fsdp", None)),
    # norms / biases / small tensors: replicate
    (r".*", ()),
]


def spec_for_path(path: str, rules=None) -> Spec:
    """The spec (over the JAX layout) of the first rule matching ``path``."""
    rules = DEFAULT_RULES if rules is None else rules
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return ()


def torch_spec(module: nn.Module, leaf: str, spec: Spec, ndim: int) -> Spec:
    """``spec`` over the JAX layout of ``module``'s ``leaf`` -> the same
    split over the torch tensor's dims (the converter's axis map)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    layout = jax_layout(module, leaf)
    if layout is None:
        return spec
    perm, _ = layout  # JAX axis j is torch axis perm[j]; a flip keeps the split
    out: List[Optional[str]] = [None] * ndim
    for j, axis in enumerate(spec):
        out[perm[j]] = axis
    return tuple(out)


def _fits(shape, spec: Spec, sizes: Dict[str, int]) -> bool:
    """A spec only applies if every named axis divides the param dim."""
    if len(spec) > len(shape):
        return False
    for dim, axis in zip(shape, spec):
        if axis is None:
            continue
        size = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            size *= sizes[a]
        if dim % size != 0:
            return False
    return True


def _sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, dict):
        return mesh
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def make_param_shardings(model: nn.Module, mesh, rules=None) -> Dict[str, Spec]:
    """{parameter name: its spec over the torch dims} for every parameter of
    ``model``, from the rule of its flax path; a spec whose axes do not
    divide the parameter falls back to replication (``()``), as in JAX.
    ``mesh``: a ``DeviceMesh`` or {axis: size}."""
    from ..training.optimizers import flax_param_name

    sizes = _sizes(mesh)
    out = {}
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        spec = torch_spec(model.get_submodule(owner), leaf,
                          spec_for_path(flax_param_name(model, name), rules), p.dim())
        out[name] = spec if _fits(p.shape, spec, sizes) else ()
    return out


def shard_params(model: nn.Module, mesh, rules=None) -> nn.Module:
    """Shard ``model`` over ``mesh`` by the rules, in place: with fsdp > 1
    FSDP2 ``fully_shard`` over the fsdp dim, each parameter stored as
    shards of the dim its rule names for fsdp (else dim 0).  The model's
    forward all-gathers the weights; the gradients come back reduced over
    fsdp, and the train step's ``mesh.data_parallel(mesh, fsdp_applied=True)``
    then averages them over dp alone.  tp > 1 raises: not ported."""
    sizes = _sizes(mesh)
    if sizes.get("tp", 1) != 1:
        raise NotImplementedError("tp > 1 (tensor-parallel weights) is not ported; every "
                                  "config sets tp: 1")
    if sizes.get("fsdp", 1) == 1:
        return model
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    specs = make_param_shardings(model, sizes, rules)
    dims = {p: next((d for d, axis in enumerate(specs[n]) if axis == "fsdp"), 0)
            for n, p in model.named_parameters()}
    fully_shard(model, mesh=mesh["fsdp"], shard_placement_fn=lambda p: Shard(dims[p]))
    return model
