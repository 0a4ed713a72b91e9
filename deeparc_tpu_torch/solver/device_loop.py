"""The on-device LM driver: blocks of LM steps with no read by the host
inside a block, PyTorch port of the JAX package's ``driver="while_loop"``
(``jax.lax.while_loop`` over the step, ``deeparc_tpu/solver/rig_grid.py``
``solve_ba_grid``, ``solver/tiles.py`` ``solve_tiles_prepared``,
``solver/ba.py`` ``solve_ba``).

A :class:`BlockLoop` holds the loop-carried state (points, camera vector
or parameters, cost, trust-region radius and decrease factor, ``k``,
``status``, and the PCG iterations so far) in buffers of its own, and
``run(k_stop)`` steps while ``status == 0 and k < k_stop``: each step's
outputs are copied into the buffers, and ``k_stop`` is a device scalar in
a buffer too, so one program serves every block.

On the card the program is ONE CUDA graph, captured at the first block
after a warm-up step and replayed once a block: the block's loop is a
conditional WHILE node (``kernels.graph_loop``), PCG inside the step
another, nested in its body. The warm-up step runs on copies of the
state with ``torch.cuda`` sync debugging set to "error", so a host read
inside the step raises there, with its reason, before the capture; it
also makes the first-call work (the kernels' build, library loading,
library handles) happen outside the capture. A block reads the host once
(``k``, ``status`` and the PCG count, one copy). There is no eager
fallback on the card: the driver captures or raises.

On the CPU (the plain version) the same program runs eagerly, its loops
in their plain form (one flag read a pass).

The sharded engines run a block on every rank of their process group:
the step's collectives sit inside the block (on the card, NCCL's inside
the WHILE nodes' bodies), every rank takes the same decisions from the
summed values, and between blocks :func:`run_blocks` takes rank 0's
wall-clock decision (``agree``).
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch

from deeparc_tpu_torch.kernels import graph_loop
from deeparc_tpu_torch.solver.ba import LM_LOOP
from deeparc_tpu_torch.utils import debug

# called with each BlockLoop right after its graph is captured (the card's
# measurements read the graph's nodes and the capture's time there)
capture_hooks: list = []


def tree_leaves(tree) -> list:
    """The tensors of a state or input tree (NamedTuples, tuples, lists,
    dicts' values, dataclasses), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tree_leaves(x)]
    return []


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def tree_signature(tree):
    """What a captured program depends on besides tensor values: the tree's
    structure, each tensor's shape, dtype and device, every other leaf."""
    if isinstance(tree, torch.Tensor):
        return ("T", tuple(tree.shape), tree.dtype, tree.device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree), tuple(tree_signature(getattr(tree, f.name))
                                  for f in dataclasses.fields(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(tree_signature(x) for x in tree))
    return ("V", repr(tree))


def copy_tree_(dst, src) -> None:
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        d.copy_(s)


class BlockLoop:
    """Blocks of LM steps over ``step(state, *inputs) -> (state, info)``.

    ``own_inputs=False`` runs the step on the caller's ``inputs`` (one
    solve); ``own_inputs=True`` keeps copies of them, which
    :meth:`set_inputs` refreshes for a later solve on a layout of the same
    shapes (the tile pipeline's filter rounds), so the captured graph
    serves every such solve; a layout of other shapes is captured again."""

    def __init__(self, step, inputs: tuple, own_inputs: bool = False):
        self.step = step
        self.own_inputs = own_inputs
        self.inputs = tree_map(torch.clone, inputs) if own_inputs else inputs
        self.state = None
        self.graph = self.record = None
        self._release = None    # frees the loop bodies' pools, once
        self.warmup_seconds = self.capture_seconds = 0.0
        self.block_seconds: list = []   # each block's replay and read

    def _drop_graph(self) -> None:
        self.graph = None
        if self._release is not None:
            self._release()
            self._release = self.record = None

    def set_inputs(self, inputs: tuple) -> None:
        """Copy a later solve's inputs into the loop's own copies (same
        shapes), or take new copies and capture again."""
        if not self.own_inputs:
            raise ValueError("set_inputs needs a BlockLoop with own_inputs")
        if tree_signature(inputs) == tree_signature(self.inputs):
            copy_tree_(self.inputs, inputs)
            return
        self._drop_graph()
        self.inputs = tree_map(torch.clone, inputs)

    def load(self, state) -> None:
        """Copy a start state into the buffers (``state.k`` an int)."""
        dev = state.status.device
        state = state._replace(
            k=torch.full((), int(state.k), dtype=torch.int64, device=dev),
            status=state.status.to(torch.int64))
        if self.state is None or tree_signature(state) != tree_signature(
                self.state):
            self._drop_graph()
            self.state = tree_map(torch.clone, state)
            self.k_stop = torch.zeros((), dtype=torch.int64, device=dev)
            self.cg = torch.zeros((), dtype=torch.int64, device=dev)
            self.out = torch.zeros(3, dtype=torch.int64, device=dev)
        else:
            copy_tree_(self.state, state)
        self.cg.zero_()

    def _program(self) -> None:
        st = self.state

        def body():
            new, info = self.step(st, *self.inputs)
            copy_tree_(st, new)
            if isinstance(info.cg_iters, torch.Tensor):
                self.cg.add_(info.cg_iters)

        graph_loop.while_loop(
            lambda: (st.status == 0) & (st.k < self.k_stop), body)
        self.out.copy_(torch.stack([st.k, st.status, self.cg]))

    def _warm_up(self) -> None:
        """One step on copies of the state, in the loops' plain form, with
        any other host read raising."""
        warm = tree_map(torch.clone, self.state)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with graph_loop.eager_loops():
                self.step(warm, *self.inputs)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            raise RuntimeError(
                "driver='while_loop' cannot capture the LM step: it reads "
                f"the device from the host ({e})") from e
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        self._warm_up()
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with graph_loop.capture(self.k_stop.device) as rec:
            try:
                with torch.cuda.graph(graph):
                    self._program()
                try:
                    graph.instantiate()
                except Exception as e:
                    kinds = [sorted(set(graph_loop.node_types(b)))
                             for b in rec.bodies]
                    raise RuntimeError(
                        "driver='while_loop': the captured LM block does not "
                        "instantiate; its loop bodies hold the node types "
                        f"{kinds} (CUgraphNodeType; a conditional body takes "
                        f"kernel, memcpy, memset, child-graph and "
                        f"conditional nodes): {e}") from e
            except Exception:
                rec.release()
                raise
        torch.cuda.synchronize()
        self.graph, self.record = graph, rec
        # the bodies' pools go with the loop (or with a new capture)
        self._release = weakref.finalize(self, rec.release)
        self.warmup_seconds = t1 - t0
        self.capture_seconds = time.perf_counter() - t1
        for hook in capture_hooks:
            hook(self)

    def while_nodes(self) -> list:
        """Conditional nodes of the captured graph: [top graph, then each
        loop body in capture order]."""
        if self.graph is None:
            return []
        return [graph_loop.count_conditional(g) for g in
                [self.graph.raw_cuda_graph()] + self.record.bodies]

    def kernel_names(self) -> list:
        """The function names of the captured graph's kernel nodes, its
        loop bodies' included: what a replay launches."""
        if self.graph is None:
            return []
        return [name for g in [self.graph.raw_cuda_graph()]
                + self.record.bodies for name in graph_loop.kernel_names(g)]

    def run(self, k_stop: int) -> tuple:
        """One block: step while status == 0 and k < k_stop. Returns
        (k, status, PCG iterations since :meth:`load`), the block's one
        read by the host. No NaN check runs inside (the driver checks the
        state between blocks)."""
        self.k_stop.fill_(k_stop)
        with debug.suspended():
            if self.state.k.is_cuda and self.graph is None:
                self._capture()
            t0 = time.perf_counter()
            if self.state.k.is_cuda:
                self.graph.replay()
            else:
                self._program()
        k, status, cg = self.out.tolist()
        self.block_seconds.append(time.perf_counter() - t0)
        return k, status, cg


def run_blocks(loop: BlockLoop, k: int, max_iterations: int,
               while_block: int, max_seconds: float, on_block=None,
               agree=bool, reducer=None, *, engine: str):
    """The host's loop between blocks, as the JAX package drives its
    ``jit_block``: the wall-clock cap is tested before each block (through
    ``agree``, which a sharded solve makes ``Reducer.agree``: rank 0's
    clock decides for every rank), blocks end at ``min(k + while_block,
    max_iterations)``, and ``on_block(k)`` (the checkpoint) runs after
    each. Under ``utils.debug.nan_debugging`` the state read back after
    each block is checked (``debug.check_block``, naming the ``engine``;
    with ``reducer``, a sharded solve, over all ranks). Returns (k,
    status, PCG iterations, seconds)."""
    if while_block < 1:
        raise ValueError(f"while_block must be >= 1, not {while_block}")
    check = debug.enabled()
    t0 = time.time()
    status, cg = 0, 0
    with torch.profiler.record_function(LM_LOOP):
        while status == 0 and k < max_iterations:
            if agree(time.time() - t0 > max_seconds):
                break
            k0 = k
            saved = tree_map(torch.clone, loop.state) if check else None
            k, status, cg = loop.run(min(k + while_block, max_iterations))
            if check:
                debug.check_block(loop, saved, k0, k, engine, reducer)
            if on_block is not None:
                on_block(k)
    return k, status, cg, time.time() - t0


def solve_blocks(loop: BlockLoop, state, options, while_block: int,
                 checkpoint_path: str | None, original, reducer=None,
                 logger=None, result=None, *, engine: str):
    """The ``driver="while_loop"`` solve of the grid and tile engines:
    :func:`run_blocks` from ``state`` with the solver-state checkpoint
    after each block (``original(state)`` gives the parameters in their
    original point order); returns a ``BAResult`` whose parameters
    (``result(state)``, by default ``original(state)``) are copies, not
    views of the loop's buffers.

    With ``reducer`` (a sharded solve; ``original`` then gathers the
    points, a collective every rank runs): rank 0's clock decides the
    wall-clock cap, and after each block rank 0 writes the checkpoint and
    one ``lm_block`` line to ``logger`` (iteration, cost, radius,
    status), as the JAX package's sharded solves do."""
    from deeparc_tpu_torch.solver.ba import BAResult, save_checkpoint

    loop.load(state)
    lead = reducer is None or reducer.rank == 0

    def on_block(k):
        st = loop.state
        if checkpoint_path:
            params = original(st)
            if lead:
                save_checkpoint(checkpoint_path, params, st.tr, k, st.cost)
        if reducer is not None and lead and logger is not None:
            logger.log("lm_block", iter=k, cost=float(st.cost),
                       radius=float(st.tr.radius), status=int(st.status))

    k, status, cg, seconds = run_blocks(
        loop, int(state.k), options.max_iterations, while_block,
        options.max_seconds, on_block,
        bool if reducer is None else reducer.agree, reducer, engine=engine)
    st = loop.state
    return BAResult(params=tree_map(torch.clone, (result or original)(st)),
                    cost=float(st.cost), iterations=k, status=status,
                    seconds=seconds, cg_iterations=cg)
