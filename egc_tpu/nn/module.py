"""A minimal module layer: dataclass modules with parameters created inline.

Each layer is a frozen dataclass whose ``__call__`` creates its parameters
and submodules where they are used (the "compact" style). Variables live
in nested dicts keyed by module path, one dict per collection
(``params``, ``batch_stats``):

- a submodule constructed inside a parent's ``__call__`` is named
  ``name=`` or, by default, ``ClassName_i`` (i counts that class within
  the parent call); a module held in a field of its parent takes the
  field's name;
- ``init(rngs, *args)`` runs the call once and returns every collection
  created; ``apply(variables, *args, rngs=..., mutable=[...])`` runs it
  against given variables and, with ``mutable``, also returns the
  collections the call updated;
- ``param(name, init_fn, *shape)`` draws from the ``params`` stream, keyed
  by the parameter's path, so a parameter's value depends only on the seed
  and its path.

``remat`` wraps a submodule call in ``jax.checkpoint``. ``Dense``,
``Embed`` and ``Dropout`` are the layers the models need.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

Path = Tuple[str, ...]

_local = threading.local()


def _stack():
    if not hasattr(_local, "frames"):
        _local.frames = []
    return _local.frames


def _path_hash(path: Path) -> int:
    return zlib.crc32("/".join(path).encode()) & 0x7FFFFFFF


class _Context:
    """State of one ``init`` or ``apply``: the variables, the random keys
    and which module instance owns which path."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.variables = variables        # {collection: nested dict}
        self.rngs = rngs                  # {stream: key}
        self.mutable = mutable            # set of collection names
        self.initializing = initializing
        self.paths: Dict[int, Path] = {}  # id(module) -> path
        self.owned = []                   # keeps registered modules alive
        self.rng_counts: Dict[Tuple[Path, str], int] = {}

    def register(self, module, path: Path):
        self.paths[id(module)] = path
        self.owned.append(module)

    def lookup(self, collection: str, path: Path):
        node = self.variables.get(collection, {})
        for k in path:
            if not isinstance(node, dict) or k not in node:
                return None
            node = node[k]
        return node

    def store(self, collection: str, path: Path, value):
        if collection not in self.mutable:
            raise ValueError(
                f"collection {collection!r} is not mutable here; pass "
                f"mutable=[{collection!r}] to apply")
        node = self.variables.setdefault(collection, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value


class _Frame:
    """One active ``__call__`` of a module."""

    def __init__(self, ctx: _Context, module, path: Path):
        self.ctx = ctx
        self.module = module
        self.path = path
        self.counts: Dict[str, int] = {}
        self.children: Dict[str, int] = {}   # name -> id(module)

    def child_path(self, module, name: Optional[str]) -> Path:
        if name is None:
            cls = type(module).__name__
            i = self.counts.get(cls, 0)
            self.counts[cls] = i + 1
            name = f"{cls}_{i}"
        owner = self.children.setdefault(name, id(module))
        if owner != id(module):
            where = "/".join(self.path) or type(self.module).__name__
            raise ValueError(f"two submodules named {name!r} in {where}")
        return self.path + (name,)


def _copy_tree(tree):
    return {k: _copy_tree(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree


class Variable:
    """Handle to one variable of a mutable-capable collection."""

    def __init__(self, ctx: _Context, collection: str, path: Path):
        self._ctx, self._collection, self._path = ctx, collection, path

    @property
    def value(self):
        return self._ctx.lookup(self._collection, self._path)

    @value.setter
    def value(self, v):
        self._ctx.store(self._collection, self._path, v)


class Module:
    """Base class; subclasses declare fields as class annotations."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        ann = dict(cls.__dict__.get("__annotations__", {}))
        if "name" in ann:
            raise TypeError("'name' is reserved for the module name")
        # every module takes an optional keyword-only ``name``
        ann["name"] = "Optional[str]"
        cls.__annotations__ = ann
        cls.name = dataclasses.field(default=None, kw_only=True,
                                     compare=False)
        dataclasses.dataclass(cls, frozen=True)
        call = cls.__dict__.get("__call__")
        if call is not None and not getattr(call, "_module_call", False):
            cls.__call__ = _wrap_call(call)

    def __post_init__(self):
        frames = _stack()
        if frames:
            frame = frames[-1]
            frame.ctx.register(self, frame.child_path(self, self.name))

    # -- inside __call__ ----------------------------------------------------
    def _frame(self) -> _Frame:
        frames = _stack()
        if not frames or frames[-1].module is not self:
            raise RuntimeError(
                f"{type(self).__name__}: variables can only be created "
                "inside the module's own __call__")
        return frames[-1]

    def param(self, name: str, init_fn: Callable, *init_args):
        f = self._frame()
        path = f.path + (name,)
        value = f.ctx.lookup("params", path)
        if value is None:
            if not f.ctx.initializing:
                raise KeyError(f"missing parameter {'/'.join(path)}")
            key = jax.random.fold_in(f.ctx.rngs["params"], _path_hash(path))
            value = init_fn(key, *init_args)
            f.ctx.store("params", path, value)
        return value

    def variable(self, collection: str, name: str,
                 init_fn: Callable[[], Any]) -> Variable:
        f = self._frame()
        path = f.path + (name,)
        if f.ctx.lookup(collection, path) is None:
            if collection not in f.ctx.mutable:
                raise KeyError(f"missing {collection} {'/'.join(path)}")
            f.ctx.store(collection, path, init_fn())
        return Variable(f.ctx, collection, path)

    def make_rng(self, stream: str):
        f = self._frame()
        if stream not in f.ctx.rngs:
            raise ValueError(f"no {stream!r} key: pass rngs={{{stream!r}: "
                             "key}} to apply")
        n = f.ctx.rng_counts.get((f.path, stream), 0)
        f.ctx.rng_counts[(f.path, stream)] = n + 1
        return jax.random.fold_in(f.ctx.rngs[stream],
                                  _path_hash(f.path + (str(n),)))

    def is_initializing(self) -> bool:
        return self._frame().ctx.initializing

    # -- entry points -------------------------------------------------------
    def init(self, rngs, *args, **kwargs) -> Dict[str, Any]:
        """Run the call once, creating every variable; returns the
        non-empty collections."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        ctx = _Context({}, dict(rngs), _ANY, initializing=True)
        _run(ctx, self, args, kwargs)
        return {c: v for c, v in ctx.variables.items() if v}

    def apply(self, variables, *args, rngs=None, mutable=(), **kwargs):
        """Run the call on ``variables``. With ``mutable`` (a list of
        collection names) returns ``(out, {collection: updated})``."""
        if isinstance(mutable, str):
            mutable = [mutable]
        mutable = set(mutable or ())
        tree = {c: (_copy_tree(v) if c in mutable else v)
                for c, v in variables.items()}
        ctx = _Context(tree, dict(rngs or {}), mutable, initializing=False)
        out = _run(ctx, self, args, kwargs)
        if not mutable:
            return out
        return out, {c: ctx.variables.get(c, {}) for c in sorted(mutable)}


class _AnyCollection:
    def __contains__(self, item):
        return True


_ANY = _AnyCollection()


def _run(ctx, module, args, kwargs):
    """Call ``module`` as the root of ``ctx`` (an init or apply inside a
    module call starts afresh and restores the outer state after)."""
    frames = _stack()
    saved = list(frames), getattr(_local, "ctx", None)
    frames.clear()
    _local.ctx = ctx
    try:
        ctx.register(module, ())
        return module(*args, **kwargs)
    finally:
        frames[:], _local.ctx = saved


def _wrap_call(call):
    @functools.wraps(call)
    def wrapped(self, *args, **kwargs):
        frames = _stack()
        ctx = getattr(_local, "ctx", None)
        if ctx is None or id(self) not in ctx.paths:
            raise RuntimeError(
                f"{type(self).__name__} called outside init/apply, or "
                "constructed outside its parent's __call__")
        frame = _Frame(ctx, self, ctx.paths[id(self)])
        # modules held in fields are children named after the field
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Module) and id(v) not in ctx.paths:
                ctx.register(v, frame.path + (f.name,))
        frames.append(frame)
        try:
            return call(self, *args, **kwargs)
        finally:
            frames.pop()

    wrapped._module_call = True
    return wrapped


def remat(fn: Callable):
    """``remat(fn)(module, *args)``: run ``fn(module, *args)`` under
    ``jax.checkpoint``, so its activations are recomputed in the backward
    pass instead of stored. ``fn`` must call ``module``."""

    def wrapped(module, *args):
        ctx = _local.ctx
        if ctx.initializing:
            return fn(module, *args)

        def pure(variables, rngs, *a):
            outer = (ctx.variables, ctx.rngs)
            ctx.variables, ctx.rngs = variables, rngs
            try:
                out = fn(module, *a)
                new = {c: ctx.variables.get(c, {}) for c in ctx.mutable}
            finally:
                ctx.variables, ctx.rngs = outer
            return out, new

        variables = {c: (_copy_tree(v) if c in ctx.mutable else v)
                     for c, v in ctx.variables.items()}
        out, new = jax.checkpoint(pure)(variables, ctx.rngs, *args)
        for c, v in new.items():
            ctx.variables[c] = v
        return out

    return wrapped


class Dense(Module):
    """``y = x @ kernel + bias`` with a ``[in, features]`` kernel."""

    features: int
    use_bias: bool = True
    kernel_init: Callable = jax.nn.initializers.lecun_normal()
    bias_init: Callable = jax.nn.initializers.zeros

    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), jnp.float32)
        y = jnp.dot(x, kernel)
        if self.use_bias:
            y = y + self.param("bias", self.bias_init, (self.features,),
                               jnp.float32)
        return y


class Embed(Module):
    """Row lookup in a ``[num_embeddings, features]`` table."""

    num_embeddings: int
    features: int
    embedding_init: Callable = jax.nn.initializers.normal(1.0)

    def __call__(self, ids):
        table = self.param("embedding", self.embedding_init,
                           (self.num_embeddings, self.features), jnp.float32)
        return jnp.take(table, ids, axis=0)


class Dropout(Module):
    """Inverted dropout drawing from the ``dropout`` key stream."""

    rate: float
    deterministic: bool = False

    def __call__(self, x):
        if self.rate == 0.0 or self.deterministic:
            return x
        if self.rate >= 1.0:
            return jnp.zeros_like(x)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep, x.shape)
        return jnp.where(mask, x / keep, jnp.zeros_like(x))

