"""The RPT0xx rule set: the JAX linter's rules (``repro.analysis.rules``)
that have a PyTorch meaning, with JAX's numbers (``RPT00n`` is the
counterpart of ``RPR00n``).

Each rule is a :class:`Rule` with a ``check_file`` hook (one file's AST)
and/or a ``check_project`` hook (the whole tree, for config-field
liveness):

- RPT001: a ``cached_property`` / ``lru_cache`` / ``functools.cache``
  member whose body builds torch tensors.  A tensor cached at first touch
  keeps the device and the mode it was made under: touched first under
  ``FakeTensorMode``, the cache hands fake tensors to every later real
  call (the PyTorch shape of JAX's cached-tracer bug).
- RPT002: a value bound from a CUDA graph replay (``DecodeGraph``'s call,
  ``CUDAGraph.replay``) and read after a later replay of the same graph
  without a ``.clone()``.  A replay returns the graph's static buffers,
  which the next replay overwrites (the counterpart of JAX's
  use-after-donation).
- RPT003: torch tensors built inside the host-only plan and layout
  builders (``RaggedLayout``, ``AttentionPlan`` other than its
  ``stacked(device)``, ``build_plan``, ``layout_for``, ``stack_layouts``'
  numpy side): plans are cached and shared, so they must stay host numpy.
- RPT004: blocking calls inside ``async def`` (JAX's list, plus
  ``torch.cuda.synchronize``, ``.item()``, ``.tolist()``, ``.cpu()`` and an
  event's ``.synchronize()``, each of which waits for the device).
- RPT005: ``check_raise`` after a ``*_step_fn[s]`` dispatch or a graph
  replay in the same function: an injected fault must fire before the step
  mutates the cache in place.
- RPT006: a ``SparseConfig`` / ``ServeConfig`` / ``ResilienceConfig``
  field that nothing reads.
- RPT007: module-level calls that touch device state (``torch.cuda.*``, a
  tensor made on a device other than ``cpu`` / ``meta``, ``.cuda()``);
  ``torch.device(...)`` and dtype constants are exempt.

RPT008 (a pragma that suppresses nothing) and RPT000 (a file that does not
parse) come from the engine, as in JAX.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple


@dataclass(frozen=True)
class Finding:
    code: str
    message: str
    path: str
    line: int
    col: int = 0

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: {self.code} {self.message}"

    def as_dict(self) -> dict:
        return {"code": self.code, "message": self.message, "path": self.path,
                "line": self.line, "col": self.col}


class FileContext:
    """One parsed file, with the names it binds to torch modules and
    functions (``import torch as th``, ``import torch.nn.functional as F``,
    ``from torch import zeros``)."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        #: local name -> the dotted torch path it stands for
        self.torch_names: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch" or a.name.startswith("torch."):
                        if a.asname:
                            self.torch_names[a.asname] = a.name
                        else:
                            self.torch_names["torch"] = "torch"
            elif isinstance(node, ast.ImportFrom) and node.module and (
                    node.module == "torch" or node.module.startswith("torch.")):
                for a in node.names:
                    self.torch_names[a.asname or a.name] = f"{node.module}.{a.name}"

    def torch_path(self, node: ast.expr) -> str:
        """The fully qualified path of a Name/Attribute chain rooted at a
        torch name ('' for anything else)."""
        path = _attr_path(node)
        root, _, rest = path.partition(".")
        full = self.torch_names.get(root)
        if full is None:
            return ""
        return f"{full}.{rest}" if rest else full


def _attr_path(node: ast.expr) -> str:
    """Dotted source path of a Name/Attribute chain ('' when dynamic)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _leaf(path: str) -> str:
    return path.rsplit(".", 1)[-1] if path else ""


def _decorator_name(dec: ast.expr) -> str:
    if isinstance(dec, ast.Call):
        dec = dec.func
    return _leaf(_attr_path(dec))


def _functions(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


#: torch paths that query or configure and build no tensor
_TORCH_NO_TENSOR = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.device",
    "torch.Size", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.is_tensor", "torch.get_default_dtype", "torch.no_grad",
    "torch.inference_mode", "torch.Generator", "torch._guards.",
)


def _builds_tensor(ctx: FileContext, call: ast.Call) -> str:
    """The torch path of a call that builds a tensor ('' otherwise)."""
    path = ctx.torch_path(call.func)
    if not path or any(path == p or path.startswith(p) for p in _TORCH_NO_TENSOR):
        return ""
    return path


class Rule:
    code: str = "RPT000"
    name: str = "?"
    description: str = ""

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        return iter(())

    def check_project(self, contexts: Sequence[FileContext]) -> Iterator[Finding]:
        return iter(())


# ---------------------------------------------------------------------------
# RPT001: cached members must not hold device tensors
# ---------------------------------------------------------------------------

_CACHING_DECORATORS = {"cached_property", "lru_cache", "cache"}
#: the port's builders of device tensors (layouts as tensors, a plan's
#: stack) and the tensor methods that place a value on a device
_DEVICE_BUILDERS = {"as_arrays", "stack_layouts", "stacked", "to", "cuda"}


class CachedTensorRule(Rule):
    """A cached member that builds torch tensors caches them with the device
    and the mode of its first touch: touched under ``FakeTensorMode`` (the
    contract verifier), the cache hands fake tensors to every later real
    call; touched on one device, another device's caller gets them too.
    Fires on a torch call that builds a tensor and on a call of the port's
    device builders (``as_arrays``, ``stack_layouts``, ``.stacked``,
    ``.to``, ``.cuda``).  Cache host values; build the tensor at the use
    site."""

    code = "RPT001"
    name = "cached-tensor"
    description = ("cached_property/lru_cache member builds torch tensors; a "
                   "first touch under FakeTensorMode or on one device caches "
                   "them for every caller")

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in _functions(ctx.tree):
            if not any(_decorator_name(d) in _CACHING_DECORATORS
                       for d in fn.decorator_list):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                what = _builds_tensor(ctx, node)
                if not what and _leaf(_attr_path(node.func)) in _DEVICE_BUILDERS:
                    what = _attr_path(node.func)
                if what:
                    yield Finding(
                        self.code,
                        f"cached member {fn.name!r} builds a tensor ({what}); "
                        "the cache keeps the device and the mode of its first "
                        "touch (fake tensors under FakeTensorMode) — cache "
                        "host values and build the tensor at the use site",
                        ctx.path, node.lineno, node.col_offset,
                    )


# ---------------------------------------------------------------------------
# RPT002: a replay's static outputs must not be read after the next replay
# ---------------------------------------------------------------------------

_GRAPH_CLASSES = {"DecodeGraph", "CUDAGraph"}


def _is_replay(path: str) -> bool:
    """A call of ``*.replay`` or of a callee named ``*graph`` (not a graph
    class's constructor)."""
    leaf = _leaf(path)
    return leaf == "replay" or (leaf.lower().endswith("graph")
                                and leaf not in _GRAPH_CLASSES)


def _target_paths(target: ast.expr) -> Set[str]:
    """Dotted paths (re)bound by an assignment target."""
    out: Set[str] = set()
    for node in ast.walk(target):
        if isinstance(node, (ast.Name, ast.Attribute)):
            p = _attr_path(node)
            if p:
                out.add(p)
    return out


class ReplayBufferRule(Rule):
    """A CUDA graph's replay writes its captured static buffers: what
    ``DecodeGraph.__call__`` returns (its logits buffer) is overwritten by
    the next replay of the same graph.  Tracks, within one function, the
    graphs bound there (``DecodeGraph(...)``, ``torch.cuda.CUDAGraph()``)
    and any callee named ``*graph``; flags a value bound from a
    replay and read after a later replay of that graph, unless it was
    rebound (say to its ``.clone()``) in between."""

    code = "RPT002"
    name = "read-after-replay"
    description = ("value bound from a CUDA graph replay is read after the next "
                   "replay of the same graph overwrote it")

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in _functions(ctx.tree):
            yield from self._check_scope(ctx, fn)

    @staticmethod
    def _graph_of(call: ast.Call, graphs: Set[str]) -> str:
        """The graph a call replays ('' when it is no replay)."""
        path = _attr_path(call.func)
        if _leaf(path) == "replay":
            return path.rsplit(".", 1)[0]
        if path in graphs or _is_replay(path):
            return path
        return ""

    def _check_scope(self, ctx, fn) -> Iterator[Finding]:
        nodes = list(ast.walk(fn))
        graphs: Set[str] = set()
        for node in nodes:
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                    and _leaf(_attr_path(node.value.func)) in _GRAPH_CLASSES):
                for t in node.targets:
                    graphs |= _target_paths(t)
        stmts = [n for n in nodes if isinstance(n, ast.stmt)]
        replays: List[Tuple[str, ast.stmt]] = []   # (graph, statement)
        bound: List[Tuple[str, str, ast.stmt]] = []  # (value, graph, statement)
        stores: Dict[str, List[int]] = {}
        for node in nodes:
            if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                    getattr(node, "ctx", None), ast.Store):
                stores.setdefault(_attr_path(node), []).append(node.lineno)
        for st in stmts:
            if isinstance(st, (ast.Assign, ast.Expr)) and isinstance(
                    st.value, ast.Call):
                g = self._graph_of(st.value, graphs)
                if not g:
                    continue
                replays.append((g, st))
                if isinstance(st, ast.Assign):
                    # what the replay was given (the cache it hands back)
                    # is no static buffer
                    given = {_attr_path(a) for a in st.value.args}
                    for t in st.targets:
                        for p in _target_paths(t) - given:
                            bound.append((p, g, st))
        for value, g, st in bound:
            later = [r for gr, r in replays if gr == g and r.lineno > st.lineno]
            if not later:
                continue
            nxt = min(later, key=lambda r: r.lineno)
            if any(st.lineno < ln <= nxt.lineno for ln in stores.get(value, ())):
                continue  # rebound (a clone, a new result) before the replay
            own = set(ast.walk(nxt))
            for node in nodes:
                if (isinstance(node, (ast.Name, ast.Attribute))
                        and isinstance(getattr(node, "ctx", None), ast.Load)
                        and node not in own and node.lineno > nxt.lineno
                        and _attr_path(node) == value):
                    yield Finding(
                        self.code,
                        f"{value!r} is a static buffer of the replay of {g!r} "
                        f"at line {st.lineno}, overwritten by its replay at "
                        f"line {nxt.lineno}, and read again at line "
                        f"{node.lineno} — .clone() it before the next replay",
                        ctx.path, node.lineno, node.col_offset,
                    )
                    break


# ---------------------------------------------------------------------------
# RPT003: plan and layout builders stay host numpy
# ---------------------------------------------------------------------------

#: host-only zones: classes whose bodies build plan descriptors (but their
#: sanctioned conversion methods), and builder functions.  ``stack_layouts``
#: builds numpy and converts through ``_t``, the conversion point.
_HOST_ZONE_CLASSES = {"RaggedLayout": (), "AttentionPlan": ("stacked",)}
_HOST_ZONE_FUNCTIONS = {
    "stack_layouts", "layout_for", "uniform_layout",
    "prefill_max_slots_arrays", "build_plan",
}


class HostDescriptorRule(Rule):
    """Plan descriptors (``RaggedLayout`` members, ``AttentionPlan``,
    ``build_plan``'s cached plans) are built once and shared by every
    caller, on every device and under fake modes: they must be host numpy
    and Python ints.  Tensors are made at the use site
    (``AttentionPlan.stacked(device)``, ``stacked._t``)."""

    code = "RPT003"
    name = "tensor-in-plan-builder"
    description = ("torch tensor built inside a host-only plan/layout builder "
                   "(RaggedLayout/AttentionPlan construction must be host numpy)")

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and node.name in _HOST_ZONE_CLASSES:
                exempt = _HOST_ZONE_CLASSES[node.name]
                skip = {c for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and m.name in exempt for c in ast.walk(m)}
                yield from self._zone(ctx, node, skip)
            elif (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and node.name in _HOST_ZONE_FUNCTIONS):
                yield from self._zone(ctx, node, set())

    def _zone(self, ctx, zone, skip) -> Iterator[Finding]:
        for node in ast.walk(zone):
            if node in skip or not isinstance(node, ast.Call):
                continue
            what = _builds_tensor(ctx, node)
            if what:
                yield Finding(
                    self.code,
                    f"{what} inside host-only plan/layout builder "
                    f"{zone.name!r}: descriptors are cached and shared across "
                    "devices and fake modes — build with numpy, convert at "
                    "the device use site",
                    ctx.path, node.lineno, node.col_offset,
                )


# ---------------------------------------------------------------------------
# RPT004: no blocking calls inside async def
# ---------------------------------------------------------------------------

_BLOCKING_PREFIXES = (
    "time.sleep", "os.system", "subprocess.", "socket.", "requests.",
    "urllib.request.", "shutil.",
)
#: attribute calls that block whatever their receiver: JAX's, and those
#: that wait for the device (``torch.cuda.synchronize``, an event's
#: ``synchronize``, a host copy)
_BLOCKING_ATTRS = {"run_until_done", "block_until_ready", "join",
                   "synchronize", "item", "tolist", "cpu"}
_BLOCKING_BUILTINS = {"open", "input"}


class AsyncBlockingRule(Rule):
    """A blocking call inside ``async def`` wedges the event loop: every
    stream it serves stalls behind it.  Flags known-blocking library calls,
    blocking builtins, host waits on the device and the engine's drains
    (``run_until_done`` / ``engine.step``).  Run the work in
    ``asyncio.to_thread`` or say why with a pragma."""

    code = "RPT004"
    name = "blocking-call-in-async"
    description = "blocking call inside async def stalls the serve loop"

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            skip: Set[ast.AST] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.FunctionDef):
                    skip.update(ast.walk(node))  # runs on its caller's schedule
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or node in skip:
                    continue
                why = self._blocking(node)
                if why:
                    yield Finding(
                        self.code,
                        f"blocking call {why!r} inside async def {fn.name!r}; "
                        "the event loop (and every stream it serves) stalls "
                        "until it returns — use asyncio.to_thread or move it "
                        "off the loop",
                        ctx.path, node.lineno, node.col_offset,
                    )

    @staticmethod
    def _blocking(call: ast.Call) -> Optional[str]:
        path = _attr_path(call.func)
        if not path:
            # a method of a call's result: x.cpu().numpy() -> .cpu()
            if isinstance(call.func, ast.Attribute) and call.func.attr in (
                    _BLOCKING_ATTRS - {"join"}):
                return f"(...).{call.func.attr}"
            return None
        if any(path == p or path.startswith(p) for p in _BLOCKING_PREFIXES):
            return path
        if path in _BLOCKING_BUILTINS:
            return path
        leaf = _leaf(path)
        if leaf in _BLOCKING_ATTRS and "." in path:
            return path
        if leaf == "step" and "engine" in path.lower():
            return path
        return None


# ---------------------------------------------------------------------------
# RPT005: fault-injection sites fire before the step dispatch
# ---------------------------------------------------------------------------

_DISPATCH_SUFFIXES = ("_step_fn", "_step_fns", "step_fn")
_INJECT_ATTR = "check_raise"




class FaultHookPlacementRule(Rule):
    """Within a function that consults the fault injector (``*.check_raise``)
    and dispatches a step (``*_step_fn[s]``, a graph replay), the injection
    site comes first: the port's steps write the cache in place, so a fault
    raised after the dispatch lands on a cache the step already moved."""

    code = "RPT005"
    name = "fault-hook-after-dispatch"
    description = ("fault-injection check_raise placed after the step dispatch "
                   "(must fire before the step writes the cache)")

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in _functions(ctx.tree):
            inject: List[int] = []
            dispatch: List[ast.Call] = []
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                path = _attr_path(node.func)
                leaf = _leaf(path)
                if leaf == _INJECT_ATTR:
                    inject.append(node.lineno)
                elif leaf.endswith(_DISPATCH_SUFFIXES) or (path and _is_replay(path)):
                    dispatch.append(node)
                elif isinstance(node.func, ast.Subscript) and isinstance(
                        node.func.value, ast.Call):
                    # self._rung_step_fns(rung)[i](...): a dispatch table
                    inner = _leaf(_attr_path(node.func.value.func))
                    if inner.endswith(_DISPATCH_SUFFIXES):
                        dispatch.append(node)
            if not inject or not dispatch:
                continue
            first = min(inject)
            for d in dispatch:
                if d.lineno < first:
                    yield Finding(
                        self.code,
                        f"step dispatched at line {d.lineno} before the "
                        f"fault-injection site at line {first}; check_raise "
                        "must fire before the step writes the cache",
                        ctx.path, d.lineno, d.col_offset,
                    )


# ---------------------------------------------------------------------------
# RPT006: config-field liveness (project-wide)
# ---------------------------------------------------------------------------

_LIVENESS_CLASSES = ("SparseConfig", "ServeConfig", "ResilienceConfig")


class ConfigLivenessRule(Rule):
    """Every ``SparseConfig`` / ``ServeConfig`` / ``ResilienceConfig`` field
    is read somewhere in the tree: a field nobody reads is a knob wired to
    nothing.  A read is any attribute load of the field's name anywhere
    (name collisions count, so the rule never cries wolf)."""

    code = "RPT006"
    name = "dead-config-field"
    description = "config dataclass field is never read anywhere in the linted tree"

    def check_project(self, contexts: Sequence[FileContext]) -> Iterator[Finding]:
        fields: Dict[str, Tuple[FileContext, str, int]] = {}
        for ctx in contexts:
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.ClassDef) or node.name not in _LIVENESS_CLASSES:
                    continue
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and isinstance(
                            stmt.target, ast.Name):
                        fields.setdefault(stmt.target.id, (ctx, node.name, stmt.lineno))
        if not fields:
            return
        read: Set[str] = set()
        for ctx in contexts:
            for node in ast.walk(ctx.tree):
                if (isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load)
                        and node.attr in fields):
                    read.add(node.attr)
        for name, (ctx, cls, line) in sorted(
                fields.items(), key=lambda kv: (kv[1][0].path, kv[1][2])):
            if name not in read:
                yield Finding(
                    self.code,
                    f"{cls}.{name} is never read anywhere in the linted tree — "
                    "wire it up or remove it (a dead flag silently accepts "
                    "configs that change nothing)",
                    ctx.path, line,
                )


# ---------------------------------------------------------------------------
# RPT007: no device state at import time
# ---------------------------------------------------------------------------

_HOST_DEVICES = ("cpu", "meta")


class ImportTimeDeviceRule(Rule):
    """Importing a module touches no device: no ``torch.cuda.*`` call (it
    initializes CUDA in every importer, the driver's and the tests'
    processes included), no tensor made on a device other than ``cpu`` /
    ``meta``, no ``.cuda()``.  ``torch.device(...)`` and dtypes are plain
    data and exempt."""

    code = "RPT007"
    name = "import-time-device-state"
    description = "module-level call touches device state at import time"

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        for node in self._module_level_calls(ctx.tree):
            why = self._device_call(ctx, node)
            if why:
                yield Finding(
                    self.code,
                    f"module-level {why} touches the device at import time; "
                    "importing must stay device-free — build it lazily, "
                    "inside a function",
                    ctx.path, node.lineno, node.col_offset,
                )

    @staticmethod
    def _device_call(ctx: FileContext, call: ast.Call) -> str:
        path = ctx.torch_path(call.func)
        if path.startswith("torch.cuda."):
            return path
        if _leaf(_attr_path(call.func)) == "cuda" or (
                isinstance(call.func, ast.Attribute) and call.func.attr == "cuda"):
            return ".cuda()"
        if not path or path == "torch.device":
            return ""
        for kw in call.keywords:
            if kw.arg != "device":
                continue
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                dev = v.value
            elif (isinstance(v, ast.Call) and ctx.torch_path(v.func) == "torch.device"
                  and v.args and isinstance(v.args[0], ast.Constant)):
                dev = str(v.args[0].value)
            else:
                return f"{path}(device=...)"  # a device known only at run time
            if dev.split(":")[0] not in _HOST_DEVICES:
                return f"{path}(device={dev!r})"
        return ""

    @staticmethod
    def _module_level_calls(tree: ast.Module):
        """Calls run at import: the module and class bodies, decorators and
        default values included, function bodies not."""
        skip: Set[ast.AST] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                body = node.body if isinstance(node.body, list) else [node.body]
                for stmt in body:
                    skip.update(ast.walk(stmt))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node not in skip:
                yield node


ALL_RULES: Tuple[Rule, ...] = (
    CachedTensorRule(),
    ReplayBufferRule(),
    HostDescriptorRule(),
    AsyncBlockingRule(),
    FaultHookPlacementRule(),
    ConfigLivenessRule(),
    ImportTimeDeviceRule(),
)

#: RPT008 is emitted by the engine from pragma accounting.
UNUSED_PRAGMA_CODE = "RPT008"
