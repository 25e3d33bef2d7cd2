"""The device mesh, parameter sharding and the collectives the sharded
layers use (counterpart of ``dynamic_llava_tpu/parallel/sharding.py``).

A mesh over the ranks of the default process group with the axes

* ``data``   -- data parallelism: each rank holds its own rows of the batch,
* ``fsdp``   -- ZeRO-3 parameter and optimizer sharding: a layer's weights
  are all-gathered where the layer runs,
* ``tensor`` -- Megatron tensor parallelism over attention heads and the
  MLP hidden width,
* ``pipe``   -- GPipe stages over the layer stack (``parallel.pipeline``).

The rules are the JAX package's ``PartitionSpec`` trees, axis tuple for
axis tuple, in this module's own spec type ``P``. Where the JAX package
lets one GSPMD program insert the collectives, every rank here runs its own
copy of the program on its local shards (multi-controller), and the model
calls the collectives below at fixed points: ``gather_layer`` in each
decoder layer, ``enter_tensor`` / ``exit_tensor`` around the
column-parallel and row-parallel projections, ``gather_full`` for the
embedding, the lm_head and the vision tower, ``data_sum`` in the losses.
They read the mesh made active by ``with mesh:``; with none active they are
the identity, and the single-device path is unchanged.

How the collectives differentiate. Rows are split over ``data`` only, so
the ranks of one ``fsdp`` or ``tensor`` group hold the same rows:

* a gather over ``fsdp`` (or a whole-leaf gather) all-gathers forward and
  takes the local slice of the gradient backward, with no sum;
* ``enter_tensor`` is the identity forward and an all-reduce backward,
  ``exit_tensor`` an all-reduce forward and the identity backward
  (Megatron's conjugate pair; ``torch.distributed.nn.functional.all_reduce``
  reduces in both directions and would scale the gradients by ``tensor``);
* every gradient is then summed over ``data`` once, after the backward
  (``reduce_grads``), and the losses' means are global (``data_sum``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..weights import map_leaves, named_leaves, params_from_numpy, resolve_device

MESH_AXES = ("data", "fsdp", "tensor", "pipe")


class P:
    """A partition spec: one mesh axis name (or None) per leading dimension
    of a leaf; the dimensions past its length are not sharded. The port's
    ``jax.sharding.PartitionSpec``, compared axis tuple for axis tuple."""

    __slots__ = ("axes",)

    def __init__(self, *axes: Optional[str]):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __eq__(self, other):
        return isinstance(other, P) and self.axes == other.axes

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"P{self.axes!r}"


# -- the mesh ---------------------------------------------------------------------

_ACTIVE: List["Mesh"] = []  # module-wide: the autograd engine's threads see it too


def active() -> Optional["Mesh"]:
    """The mesh of the innermost ``with mesh:`` block, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class Mesh:
    """The four named axes over the ranks of the default process group
    (a ``DeviceMesh`` underneath). ``with mesh:`` makes it the one the
    model's collectives use."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = dict(zip(MESH_AXES, device_mesh.mesh.shape))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device})"


def mesh_shape(n: int, data: int = 1, fsdp: int = -1, tensor: int = 1,
               pipe: int = 1) -> Tuple[int, int, int, int]:
    """The JAX rule: ``fsdp == -1`` takes what the other axes leave of the
    ``n`` ranks, and the product must be ``n``."""
    if fsdp == -1:
        fsdp = n // (data * tensor * pipe)
    if data * fsdp * tensor * pipe != n:
        raise ValueError(f"mesh (data, fsdp, tensor, pipe) = {(data, fsdp, tensor, pipe)} "
                         f"does not cover the {n} ranks")
    return data, fsdp, tensor, pipe


def make_mesh(data: int = 1, fsdp: int = -1, tensor: int = 1, pipe: int = 1,
              device_type: str = "cuda") -> Mesh:
    """A mesh over every rank of the default process group; one card a rank
    (``LOCAL_RANK``) on ``"cuda"``, where the group uses NCCL unless it was
    made otherwise, and gloo on ``"cpu"``. Without a group, one is made
    from the environment ``torchrun`` sets. ``"cuda"`` on a machine
    without a card raises."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device_type)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    shape = mesh_shape(dist.get_world_size(), data, fsdp, tensor, pipe)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    return Mesh(init_device_mesh(device.type, shape, mesh_dim_names=MESH_AXES), device)


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


# -- the spec trees (the JAX package's, axis tuple for axis tuple) ---------------------

# one decoder layer's leaves, without the stacked layer axis
LAYER_SPECS = {
    "input_ln": (None,),
    "post_ln": (None,),
    "q": ("fsdp", "tensor"),
    "k": ("fsdp", "tensor"),
    "v": ("fsdp", "tensor"),
    "o": ("tensor", "fsdp"),
    "gate": ("fsdp", "tensor"),
    "up": ("fsdp", "tensor"),
    "down": ("tensor", "fsdp"),
}
# LoRA adapters: A sharded on the input dim, B on the output dim
LORA_SPECS = {"a": ("fsdp", None), "b": (None, "tensor"), "s": None}
EMBED_SPEC = P("tensor", "fsdp")
LM_HEAD_SPEC = P("fsdp", "tensor")
ROW_PARALLEL = ("o", "down")  # contract over the tensor-sharded dim


def llama_param_specs(cfg, pipe: bool = False) -> dict:
    """Specs mirroring the decoder's param tree: ``fsdp`` shards the input
    dim of the stacked ``[L, in, out]`` weights, ``tensor`` the per-head /
    hidden dim; with ``pipe`` the stacked layer axis is sharded over
    ``pipe`` too (the stack must be in pipeline order, ``parallel.pipeline``)."""
    lax0 = "pipe" if pipe else None
    specs = {
        "embed": EMBED_SPEC,
        "layers": {name: P(lax0, *axes) for name, axes in LAYER_SPECS.items()},
        "final_ln": P(None),
        "lm_head": LM_HEAD_SPEC,
    }
    if cfg.tie_word_embeddings:
        specs.pop("lm_head")
    return specs


def clip_param_specs() -> dict:
    ln = {"w": P(None), "b": P(None)}
    return {
        "class_embedding": P(None),
        "patch_embedding": P(None, "fsdp"),
        "position_embedding": P(None, "fsdp"),
        "pre_ln": ln,
        "layers": {
            "ln1_w": P(None, None), "ln1_b": P(None, None),
            "ln2_w": P(None, None), "ln2_b": P(None, None),
            "q_w": P(None, "fsdp", "tensor"), "q_b": P(None, "tensor"),
            "k_w": P(None, "fsdp", "tensor"), "k_b": P(None, "tensor"),
            "v_w": P(None, "fsdp", "tensor"), "v_b": P(None, "tensor"),
            "o_w": P(None, "tensor", "fsdp"), "o_b": P(None, None),
            "fc1_w": P(None, "fsdp", "tensor"), "fc1_b": P(None, "tensor"),
            "fc2_w": P(None, "tensor", "fsdp"), "fc2_b": P(None, None),
        },
        "post_ln": ln,
    }


def _replicated_like(tree):
    return map_leaves(lambda _path, _leaf: P(), tree)


def llava_param_specs(cfg, params, pipe: bool = False) -> dict:
    """Specs for the whole bundle; the projector and the predictors are
    small and replicated."""
    llm_specs = llama_param_specs(cfg.text, pipe=pipe)
    lax0 = "pipe" if pipe else None
    for key in params["llm"]["layers"]:
        if key.endswith("_lora"):
            llm_specs["layers"][key] = {
                k: P() if axes is None else P(lax0, *axes) for k, axes in LORA_SPECS.items()}
    specs = {
        "llm": llm_specs,
        "vision_tower": clip_param_specs(),
        "mm_projector": _replicated_like(params["mm_projector"]),
    }
    if "predictors" in params:
        specs["predictors"] = _replicated_like(params["predictors"])
    return specs


def batch_specs(tree) -> Any:
    """Every leaf's leading (batch) dim over ``data``."""
    return map_leaves(lambda _path, _leaf: P("data"), tree)


def specs_by_path(specs) -> Dict[str, P]:
    return dict(named_leaves(specs))


# -- placing and gathering whole trees -----------------------------------------------


def _chunk(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what}: {n} does not split into {parts} shards")
    return n // parts


def local_shard(t: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a full leaf, as a new contiguous tensor on the
    mesh's device (the full leaf can then be freed)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            size = _chunk(t.shape[dim], mesh.size(axis), f"dim {dim} over {axis!r}")
            t = t.narrow(dim, mesh.coord(axis) * size, size)
    return torch.empty(t.shape, dtype=t.dtype, device=mesh.device).copy_(t)


def _zip_specs(fn, params, specs, path=""):
    """``fn(path, leaf, spec)`` over ``params`` and its spec tree; a leaf
    that meets a sub-tree (or the other way round) raises."""
    if isinstance(specs, P):
        if not isinstance(params, torch.Tensor):
            kind = sorted(params) if isinstance(params, dict) else type(params).__name__
            raise ValueError(
                f"{path}: a {kind} leaf where the spec tree has a tensor: a quantized "
                "({q|q4, s}) weight cannot be sharded, the mesh takes the float trees "
                "the JAX specs describe")
        return fn(path, params, specs)
    if isinstance(specs, dict):
        if not isinstance(params, dict) or sorted(params) != sorted(specs):
            got = sorted(params) if isinstance(params, dict) else type(params).__name__
            raise ValueError(f"{path}: params {got} against specs {sorted(specs)}")
        return {k: _zip_specs(fn, params[k], specs[k], f"{path}/{k}".lstrip("/"))
                for k in params}
    if not isinstance(params, (list, tuple)) or len(params) != len(specs):
        raise ValueError(f"{path}: params and specs differ in structure")
    return type(params)(_zip_specs(fn, p, s, f"{path}/[{i}]".lstrip("/"))
                        for i, (p, s) in enumerate(zip(params, specs)))


def shard_params(params, mesh: Mesh, specs) -> Any:
    """Each rank keeps its local shard of every leaf (copies on the mesh's
    device)."""
    return _zip_specs(lambda _path, t, s: local_shard(t, s, mesh), params, specs)


def shard_numpy(tree, mesh: Mesh, specs, dtype: torch.dtype = torch.bfloat16) -> Any:
    """This rank's shards of a tree of numpy arrays (the JAX package's
    single-device params, say): ``weights.params_from_numpy`` on the host,
    then ``shard_params`` (only the shards reach the mesh's device)."""
    return shard_params(params_from_numpy(tree, "cpu", dtype), mesh, specs)


def local_tree(full, specs_of: Dict[str, P], mesh: Mesh, prefix: str = "") -> Any:
    """``shard_params`` for a sub-tree whose full paths are ``prefix`` +
    its own (a checkpoint's trees)."""
    return map_leaves(lambda path, t: local_shard(t, specs_of[prefix + path], mesh), full)


@torch.no_grad()
def gather_leaf(t: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """The full leaf on every rank (no autograd)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = _all_gather(t, dim, mesh.group(axis), mesh.size(axis))
    return t


def gather_params(params, specs, mesh: Mesh) -> Any:
    """Full leaves on every rank (for saving and export); every rank must
    call it."""
    return _zip_specs(lambda _path, t, s: gather_leaf(t, s, mesh), params, specs)


# -- the autograd collectives -----------------------------------------------------------


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; the local slice of the gradient
    backward (the group's ranks computed the same gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, coord, n):
        ctx.dim, ctx.coord, ctx.size = dim, coord, x.shape[dim]
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.coord * ctx.size, ctx.size), None, None, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather(x: torch.Tensor, dim: int, axis: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    mesh = mesh or active()
    return _Gather.apply(x, dim, mesh.group(axis), mesh.coord(axis), mesh.size(axis))


def enter(x: torch.Tensor, axis: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Identity forward; the gradient summed over ``axis`` backward."""
    mesh = mesh or active()
    return _CopyTo.apply(x, mesh.group(axis))


def reduce(x: torch.Tensor, axis: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Summed over ``axis`` forward; the identity backward."""
    mesh = mesh or active()
    return _ReduceFrom.apply(x, mesh.group(axis))


# -- the model's hooks (the identity without an active mesh) --------------------------


def gather_full(t: torch.Tensor, spec: P) -> torch.Tensor:
    """The whole leaf, gathered over every axis of ``spec``."""
    mesh = active()
    if mesh is None:
        return t
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = gather(t, dim, axis, mesh)
    return t


def gather_tree(tree, specs) -> Any:
    """``gather_full`` over a sub-tree and its specs."""
    if active() is None:
        return tree
    return _zip_specs(lambda _path, t, s: gather_full(t, s), tree, specs)


def _lora_local(mesh: Mesh, base: str, ad: dict) -> dict:
    """An adapter laid out for its projection's tensor-parallel form. A is
    gathered whole over ``fsdp``; its gradient is partial over ``tensor``
    (each rank sees its own heads), hence ``enter``. Column-parallel: B's
    local columns give the local outputs. Row-parallel: the local rows of
    A meet the local input, and the whole B (gathered, its partial gradient
    summed by ``enter``) makes a partial delta that the projection's
    ``exit_tensor`` sums with the partial product."""
    a = enter(gather(ad["a"], 0, "fsdp", mesh), "tensor", mesh)
    b = ad["b"]
    if base in ROW_PARALLEL:
        rows = a.shape[0] // mesh.size("tensor")
        a = a.narrow(0, mesh.coord("tensor") * rows, rows)
        b = enter(gather(b, 1, "tensor", mesh), "tensor", mesh)
    return {"a": a, "b": b, "s": ad["s"]}


def gather_layer(lp: dict) -> dict:
    """One decoder layer's weights as its sharded form uses them: gathered
    over ``fsdp``, the local ``tensor`` slice kept. Called inside the layer,
    so that under activation checkpointing the backward gathers again and
    the gathered weights are never saved."""
    mesh = active()
    if mesh is None:
        return lp
    out = {}
    for name, w in lp.items():
        if name.endswith("_lora"):
            out[name] = _lora_local(mesh, name[: -len("_lora")], w)
            continue
        if not isinstance(w, torch.Tensor):
            raise ValueError(f"layer leaf {name!r} is quantized: the mesh takes float trees")
        for dim, axis in enumerate(LAYER_SPECS[name]):
            if axis == "fsdp":
                w = gather(w, dim, "fsdp", mesh)
        out[name] = w
    return out


def enter_tensor(x: torch.Tensor) -> torch.Tensor:
    """Before a column-parallel projection (q/k/v, gate/up)."""
    mesh = active()
    return x if mesh is None else enter(x, "tensor", mesh)


def exit_tensor(x: torch.Tensor) -> torch.Tensor:
    """After a row-parallel projection (o, down): the partial sums added."""
    mesh = active()
    return x if mesh is None else reduce(x, "tensor", mesh)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """A loss's sum or count over every rank's rows (forward all-reduce,
    identity backward: each rank's gradient is then that of its own rows
    in the global mean)."""
    mesh = active()
    return x if mesh is None else reduce(x, "data", mesh)


def data_size() -> int:
    mesh = active()
    return 1 if mesh is None else mesh.size("data")


def local_heads(n: int) -> int:
    """``n`` attention (or KV) heads as one ``tensor`` rank holds them."""
    mesh = active()
    if mesh is None:
        return n
    return _chunk(n, mesh.size("tensor"), "heads over 'tensor'")


def check_heads(text_cfg, mesh: Mesh) -> None:
    """Tensor parallelism splits whole heads: query and KV heads must both
    divide by ``tensor``."""
    t = mesh.size("tensor")
    for what in ("num_attention_heads", "num_key_value_heads"):
        _chunk(getattr(text_cfg, what), t, f"{what} over 'tensor'")


# -- rows and gradients -------------------------------------------------------------------


def local_rows(x: Optional[torch.Tensor], mesh: Mesh) -> Optional[torch.Tensor]:
    """This rank's rows of a global batch tensor (the batch is split over
    ``data`` only)."""
    if x is None:
        return None
    rows = _chunk(x.shape[0], mesh.size("data"), "batch rows over 'data'")
    return x.narrow(0, mesh.coord("data") * rows, rows)


@torch.no_grad()
def reduce_grads(grads: Dict[str, torch.Tensor], mesh: Mesh) -> None:
    """Sum every gradient over ``data``, in place."""
    group = mesh.group("data")
    for path in sorted(grads):
        dist.all_reduce(grads[path], group=group)


@torch.no_grad()
def reduce_sumsq(sumsq: Dict[str, torch.Tensor], specs_of: Dict[str, P],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Per-leaf sums of squares of local shards -> of the whole leaves: each
    summed over the axes its leaf is sharded on (``data`` excluded: the
    gradients are already summed over it)."""
    by_axes: Dict[Tuple[str, ...], List[str]] = {}
    for path in sorted(sumsq):
        axes = tuple(sorted({a for a in specs_of[path] if a is not None and a != "data"}))
        by_axes.setdefault(axes, []).append(path)
    out = dict(sumsq)
    for axes in sorted(by_axes):
        if not axes:
            continue
        paths = by_axes[axes]
        stacked = torch.stack([sumsq[p].float() for p in paths])
        for axis in axes:
            dist.all_reduce(stacked, group=mesh.group(axis))
        out.update(zip(paths, stacked.unbind(0)))
    return out

