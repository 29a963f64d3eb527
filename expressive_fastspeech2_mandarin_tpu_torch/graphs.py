"""CUDA graphs: the port's ``jax.jit``.

The JAX package runs each of its steps as one compiled program: ``jax.jit``
traces a function once for each set of input shapes, dtypes and static
arguments, and then runs the compiled program (``synth/synthesizer.py:193-
215``, ``train/step.py:93-120`` there). The PyTorch counterpart of a
compiled program with static shapes is a CUDA graph. ``Graphs.jit(fn)``
returns a callable that, for each new key,

* copies the tensor inputs into static buffers of its own;
* calls ``fn`` ``WARMUP_CALLS`` times on a side stream, so that cuBLAS and
  cuDNN pick their algorithms and allocate their workspaces, the kernels'
  libraries load and the MRF weights get packed;
* captures one call under ``torch.cuda.graph``, in the memory pool that the
  owner's graphs share (a new one once none of them lives: the caching
  allocator refuses a capture into a pool all of whose graphs were
  released, ``Graphs.capture_pool``);

and from then on copies the inputs into the buffers and replays the graph.
The outputs are cloned out of the pool after each replay, before another
replay in the pool can overwrite them. The key is the inputs' shapes,
dtypes and devices, the static (non-tensor) arguments, grad and inference
mode and the TF32 switches (``train.loop.matmul_precision``): a graph keeps
the kernels it was captured with. An owner keeps ``MAX_GRAPHS`` graphs a
function (or the ``max_graphs`` it was compiled with), the least recently
used dropped first.

What a graph reads besides its inputs, the owner's weights and buffers, it
reads at the addresses it was captured with. The owner names those tensors
(``state``). Its graphs are kept only while each is the same tensor, at the
version it had at the owner's last capture or call: a weight loaded in place, a
tensor replaced (a model loaded, a position table regrown) or a cached
image of a weight gone stale (``ops.mrf_resblock``'s packed weights) drops
every graph of the owner before any replay. A capture's own warm-up may
replace one too (a longer key regrows the position table): the graphs
captured before it then go, as the old tensor does; a tensor the warm-up
only adds (the first regrown table) leaves them. A function that writes
its state (the train step) is captured with ``mutates=True``: the state
and the generators' states are saved before the warm-up and put back
after the capture, so that the first replay makes the call's one step.

A function that runs collectives (a data-parallel step over NCCL,
``train.step``) captures them with the rest: its warm-up runs them eagerly,
so a capture is never a process's first collective (the one that creates
NCCL's communicator, which a capture cannot), the capture runs none, and
each replay runs the captured set. Ranks stay matched only if every rank
captures, replays and drops its graphs at the same calls (``train.loop``
keeps them so); the state that ``mutates=True`` puts back after the
warm-up is the one from before it, alike on every rank.

Dropout draws from the owner's generators. Each is registered with every
graph (``CUDAGraph.register_generator_state``), so that a replay draws from
the generator's state when it runs and moves it on as an eager call does;
where PyTorch lacks that call, a capture that needs it raises.

The kernels' launch counters (each module's ``COUNTERS`` in
``ops.flash_mha`` and ``ops.mrf_resblock``) count in Python, which a replay does not run. The warm-up and the capture
leave them as they found them, and each replay adds what the capture
counted: a call counts its launches once, whether it captured or replayed.

Python's cyclic collector is off while a stream captures
(``capturing``): an owner and its graphs form a cycle, so the collector
frees a dead owner's graphs, and destroying a graph inside another's
capture invalidates that capture.

On CPU tensors ``fn`` runs as it is, as ``jax.jit`` on the CPU still runs
the function. A capture that fails raises; nothing falls back to eager.
PyTorch then leaves the default CUDA generator mid-capture, so the
process's later CUDA random draws raise too: a failed capture ends the
run.
"""

from __future__ import annotations

import contextlib
import gc
import weakref
from collections import OrderedDict
from collections.abc import Callable, Iterable

import torch
from torch.utils import _pytree as pytree

from .ops import flash_mha, mrf_resblock

WARMUP_CALLS = 2
MAX_GRAPHS = 32
COUNTERS = tuple((module, name) for module in (flash_mha, mrf_resblock)
                 for name in module.COUNTERS)


def read_counters() -> list[int]:
    return [getattr(module, name) for module, name in COUNTERS]


def set_counters(values: Iterable[int]) -> None:
    for (module, name), value in zip(COUNTERS, values):
        setattr(module, name, value)


def add_counters(deltas: Iterable[int]) -> None:
    set_counters(a + b for a, b in zip(read_counters(), deltas))


def module_tensors(*modules: torch.nn.Module) -> list[torch.Tensor]:
    """Every parameter and buffer of ``modules`` and their submodules, read
    from the modules' own tables (a fraction of ``parameters()``' cost: a
    compiled function lists them at every call)."""
    return [t for root in modules for m in root.modules()
            for table in (m._parameters, m._buffers)
            for t in table.values() if t is not None]


def _version(t: torch.Tensor) -> int:
    # Inference tensors keep no version; their identity still counts.
    return 0 if t.is_inference() else t._version


def _meta(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype, t.device)


def _flatten(args: tuple) -> tuple[list[torch.Tensor], tuple]:
    """The tensors of ``args`` (tensors, dicts of tensors, static values)
    in order, and a hashable description of the rest."""
    tensors, desc = [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            tensors.append(a)
            desc.append(_meta(a))
        elif isinstance(a, dict):
            tensors.extend(a.values())
            desc.append(tuple((k, _meta(v)) for k, v in a.items()))
        else:
            desc.append(("static", a))
    return tensors, tuple(desc)


def _rebuild(args: tuple, tensors: list[torch.Tensor]) -> tuple:
    """``args`` with its tensors replaced, in order, by ``tensors``."""
    it = iter(tensors)
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(next(it))
        elif isinstance(a, dict):
            out.append({k: next(it) for k in a})
        else:
            out.append(a)
    return tuple(out)


def _clone(out):
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, out)


@contextlib.contextmanager
def capturing(graph, pool=None):
    """``torch.cuda.graph(graph, pool=pool)`` with the cyclic garbage
    collector off: a collection inside the capture may free another
    graph, which invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        if enabled:
            gc.enable()


def register_generator(graph, generator: torch.Generator) -> None:
    """Register a CUDA generator's state with ``graph`` before its capture;
    raise where this PyTorch cannot."""
    if generator.device.type != "cuda":
        return
    register = getattr(graph, "register_generator_state", None)
    if register is None:
        raise RuntimeError(
            f"torch {torch.__version__} has no "
            f"CUDAGraph.register_generator_state: a graph cannot draw "
            f"from the dropout generator")
    register(generator)


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.launches = outputs, launches


class Graphs:
    """The graphs of one owner (a Synthesizer, a train state): the memory
    pool they share, the functions compiled for it (``jit``), the tensors
    they read besides their inputs (``state``) and the generators they draw
    from (``generators``), each a callable that lists them."""

    def __init__(self, state: Callable[[], Iterable[torch.Tensor]] = tuple,
                 generators: Callable[[], Iterable[torch.Generator]] = tuple):
        self.state = state
        self.generators = generators
        self.compiled: weakref.WeakSet[Compiled] = weakref.WeakSet()
        self.pool = None
        # The state's tensors as of the last capture or check (held, so
        # that none dies under a graph), with their identities and
        # versions.
        self._held: tuple[list[torch.Tensor], list[tuple[int, int]]] | None
        self._held = None

    def jit(self, fn: Callable, mutates: bool = False,
            max_graphs: int = MAX_GRAPHS) -> "Compiled":
        c = Compiled(self, fn, mutates, max_graphs)
        self.compiled.add(c)
        return c

    def count(self) -> int:
        """Graphs held over every compiled function."""
        return sum(len(c.graphs) for c in self.compiled)

    def drop(self) -> None:
        """Drop every graph and the pool; the next call captures anew."""
        for c in self.compiled:
            c.graphs.clear()
        self.pool = None
        self._held = None

    def capture_pool(self):
        """The memory pool a new capture goes into: the owner's while one
        of its graphs lives, else a new one. Once every graph captured
        into a pool is released (the functions compiled for it died, as a
        train loop's do when it returns), CUDA's caching allocator refuses
        a capture into that pool."""
        if self.pool is None or not self.count():
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def _fingerprint(self):
        tensors = list(self.state())
        return tensors, [(id(t), _version(t)) for t in tensors]

    def check(self) -> bool:
        """Whether a state tensor was replaced or written since the last
        capture or check; if so, every graph is dropped."""
        held = self._fingerprint()
        changed = self._held is not None and held[1] != self._held[1]
        if changed:
            self.drop()
        self._held = held
        return changed

    def captured(self) -> None:
        """After a capture: the state as the new graph read it becomes the
        one held. Where the warm-up replaced a tensor that ``check`` held
        at the call's start (a position table regrown), the graphs
        captured before read the old one, which nothing keeps alive any
        more: they are dropped (the pool stays, the new graph is in it).
        A tensor only added leaves them."""
        held = self._fingerprint()
        if self._held is not None and (
                {i for i, _ in self._held[1]} - {i for i, _ in held[1]}):
            for c in self.compiled:
                c.graphs.clear()
        self._held = held

    def _save(self):
        """Each state tensor and generator with a copy of its value (the
        warm-up may add tensors to the state: a position table grown)."""
        return ([(t, t.detach().clone()) for t in self.state()],
                [(g, g.get_state()) for g in self.generators()])

    @staticmethod
    def _restore(saved) -> None:
        tensors, gens = saved
        with torch.no_grad():
            for t, value in tensors:
                t.copy_(value)
        for g, value in gens:
            g.set_state(value)


def counted_capture(warm_up: Callable[[], object],
                    capture: Callable[[], object]) -> tuple[object, list]:
    """``warm_up()`` then ``capture()``: the capture's result and the
    launches it counted; the counters are left as they were found."""
    before = read_counters()
    try:
        warm_up()
        warm = read_counters()
        out = capture()
        return out, [a - b for a, b in zip(read_counters(), warm)]
    finally:
        set_counters(before)


class Compiled:
    """``fn`` captured per key on the card, called as it is on the CPU;
    made by ``Graphs.jit``. Positional arguments are tensors, dicts of
    tensors or static values; keyword arguments are static."""

    def __init__(self, owner: Graphs, fn: Callable, mutates: bool,
                 max_graphs: int = MAX_GRAPHS):
        self.owner, self.fn, self.mutates = owner, fn, mutates
        self.max_graphs = max_graphs
        self.graphs: OrderedDict[tuple, _Graph] = OrderedDict()

    def __call__(self, *args, **kwargs):
        tensors, desc = _flatten(args)
        self.owner.check()
        device = next((t.device for t in tensors if t.is_cuda), None)
        if device is None:
            return self.fn(*args, **kwargs)
        key = (desc, tuple(sorted(kwargs.items())), torch.is_grad_enabled(),
               torch.is_inference_mode_enabled(),
               torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        g = self.graphs.get(key)
        if g is None:
            g = self._capture(key, args, kwargs, tensors, device)
        else:
            self.graphs.move_to_end(key)
        return self._replay(g, tensors)

    @staticmethod
    def _replay(g: _Graph, tensors: list[torch.Tensor]):
        for buf, t in zip(g.inputs, tensors):
            buf.copy_(t)
        g.graph.replay()
        add_counters(g.launches)
        return _clone(g.outputs)

    def _capture(self, key, args, kwargs, tensors, device) -> _Graph:
        owner = self.owner
        inputs = [t.detach().clone() for t in tensors]
        call_args = _rebuild(args, inputs)
        graph = torch.cuda.CUDAGraph()

        def warm_up():
            stream = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    self.fn(*call_args, **kwargs)
            stream.wait_stream(side)

        def capture():
            for gen in owner.generators():
                register_generator(graph, gen)
            with capturing(graph, owner.capture_pool()):
                return self.fn(*call_args, **kwargs)

        saved = owner._save() if self.mutates else None
        try:
            outputs, launches = counted_capture(warm_up, capture)
        finally:
            if saved is not None:
                owner._restore(saved)
        owner.captured()
        g = _Graph(graph, inputs, outputs, launches)
        self.graphs[key] = g
        while len(self.graphs) > self.max_graphs:
            self.graphs.popitem(last=False)
        return g
