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

``shard_params`` applies the tp axis first (tensor-parallel weights,
``tensor_parallel``): every parameter becomes a DTensor on the mesh's tp
dim, ``Shard`` on the dim its rule names for tp (q / k / v and ``wi_0`` /
``wi_1`` on their output features, ``out`` and ``wo`` on their input
features, the v2 head's ``conv2`` on the vocabulary), ``Replicate``
otherwise, as in JAX where an axis does not divide the dim (``_fits``); the
modules that own split weights get the tp group (``module.tp``) and put the
collectives around their products.  Then the fsdp axis, with FSDP2
``fully_shard`` over the mesh's fsdp dim on top (torch's 2-D recipe):
every parameter is stored as shards of the dim its rule names for fsdp
(dim 0 where the rule names none: FSDP2 shards every parameter it manages),
and the root module's forward all-gathers the weights over fsdp first, so
the kernels run on gathered tensors (each rank's tp shards under tp).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from torch import nn

from ..core.convert import jax_layout
from .tensor_parallel import TensorParallel, use_local_params

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


def _tp_dim(spec: Spec) -> Optional[int]:
    return next((d for d, axis in enumerate(spec) if axis == "tp"), None)


def _split_over_tp(model: nn.Module, mesh, specs: Dict[str, Spec]) -> TensorParallel:
    """Each parameter as a DTensor on ``mesh``'s tp dim (this rank's chunk
    of its tp dim, or the whole tensor where its spec names no tp), and
    ``module.tp`` set on every module whose ``tp_leaves`` are split."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    tp_mesh = mesh["tp"]
    tp = TensorParallel(tp_mesh.get_group(), tp_mesh.get_local_rank(), tp_mesh.size())
    dims = {name: _tp_dim(spec) for name, spec in specs.items()}
    for prefix, module in model.named_modules():
        # an attention whose heads tp does not divide keeps its weights whole:
        # a rank's columns would cut a head, which its kernels cannot attend;
        # so does one whose ranks' head count would not be a multiple of its
        # ``head_multiple`` (2 where the fused sublayer kernels 9 - 12 take
        # it, which then run at full width on every rank)
        heads, multiple = getattr(module, "num_heads", 0), getattr(module, "head_multiple", 1)
        if (heads % tp.size or heads // tp.size % multiple) and hasattr(type(module), "tp_leaves"):
            for leaf in type(module).tp_leaves:
                dims[f"{prefix}.{leaf}" if prefix else leaf] = None
    for name, p in list(model.named_parameters()):
        dim = dims[name]
        part = p.detach() if dim is None else p.detach().chunk(tp.size, dim)[tp.rank]
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(
            DTensor.from_local(part.contiguous(), tp_mesh,
                               [Replicate() if dim is None else Shard(dim)], run_check=False),
            requires_grad=p.requires_grad))
    for prefix, module in model.named_modules():
        leaves = [f"{prefix}.{leaf}" if prefix else leaf
                  for leaf in getattr(type(module), "tp_leaves", ())]
        split = {dims[n] is not None for n in leaves if n in dims}
        if len(split) > 1:
            raise ValueError(f"{prefix}: its weights {leaves} are split over tp only in part")
        if split == {True}:
            module.tp = tp
    return tp


def shard_params(model: nn.Module, mesh, rules=None) -> nn.Module:
    """Shard ``model`` over ``mesh`` by the rules, in place: with tp > 1
    every parameter a DTensor on the tp dim (this rank's shard of the dim
    its rule names for tp, else replicated), each module's forward reading
    its local tensors (``tensor_parallel.use_local_params``); with fsdp > 1
    FSDP2 ``fully_shard`` over the fsdp dim on top, each parameter stored
    as shards of the dim its rule names for fsdp (else dim 0).  The model's
    forward all-gathers the weights over fsdp; the gradients come back
    reduced over fsdp, and the train step's ``mesh.data_parallel(mesh,
    fsdp_applied=True)`` then averages them over dp alone."""
    sizes = _sizes(mesh)
    if sizes.get("tp", 1) == 1 and sizes.get("fsdp", 1) == 1:
        return model
    specs = make_param_shardings(model, sizes, rules)
    tp = _split_over_tp(model, mesh, specs) if sizes.get("tp", 1) > 1 else None
    if sizes.get("fsdp", 1) > 1:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        dims = {p: next((d for d, axis in enumerate(specs[n]) if axis == "fsdp"), 0)
                for n, p in model.named_parameters()}
        fully_shard(model, mesh=mesh["fsdp"], shard_placement_fn=lambda p: Shard(dims[p]))
    if tp is not None:
        model._tensor_parallel = tp
        use_local_params(model, getattr(model, "transformer_layers", ()))
    return model
