"""Beam search with a lazy-ancestry KV cache (counterpart of ``generation/beam_search.py``).

The JAX package runs each decode stage as one ``lax.while_loop``: its exit
test and step index live on the device. Here each stage is one decode step
written as pure tensor code over a state on the device (the step index
``t``, live and finished sequences and scores, the ancestry, a ``done``
flag and the guided hook's state), with no host read and no Python branch
on ``t``:

* at its top the step computes the JAX ``cond_fn``: the provably safe early
  exit (no live beam can beat the worst finished hypothesis) or the end of
  the stage; once either holds it leaves every state tensor as it was
  (``torch.where`` on the flag) and ``t`` stops advancing, so steps run
  past the exit change nothing and results equal JAX's exactly;
* the slot-flattened self cache gets this step's rows at slot = live-beam
  index, and an int32 ancestry table (B, K, L) records which slot holds
  beam n's time-l row, so beam reordering never moves the cache; the
  kernels read ``t`` from device memory;
* cross-attention K/V are projected once per request, at batch size;
* HF semantics with the reference's generation config: log_softmax, the
  logits hook, forced EOS at ``t == max_length - 2``, length-normalised
  finished hypotheses, ``num_return_sequences = num_beams``, beams sorted
  by normalised score.

On a CUDA device the step of each stage is captured once as a CUDA graph
(:class:`BeamDecoder` keeps the graphs and their static buffers per shape)
and the host replays it ``bound - 1 - t0`` times per stage, reading ``done``
once every ``check_every`` replays and skipping the rest of the decode once
it is set: one graph per stage, as the JAX package runs one ``while_loop``
per stage. Elsewhere, or with ``cuda_graph=False``, the same step runs
eagerly in the same loop.

Under tensor parallelism (a model built on a mesh with a model axis) each
rank decodes with its slices: the decode copy and :meth:`BeamDecoder.refresh`
keep them, the self caches hold its heads, and the step's sums over the
model group (attention and FFN outputs, the gathered logits) run inside the
step, so every rank's state is the same. A stage's step is captured as a
CUDA graph only where those sums can be captured: when the model group's
backend is NCCL. Under gloo (ranks sharing one card, or the CPU) the steps
run eagerly; ``stats["graph"]`` says which route ran.

Ties in every top-k break toward the lower index, as ``jax.lax.top_k`` does
(a stable descending sort), so fp32 runs pick the beams the JAX package
picks. The JAX package's rounding of stage sizes to its kernel's tiling is
not needed.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.seq2seq import Seq2SeqModel
from ..ops import _cuda
from ..ops.attention import make_attention_bias
from ..ops.layers import Dense

NEG_INF = -1.0e7


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def decode_model(model: Seq2SeqModel) -> Seq2SeqModel:
    """The model to decode with: for bf16 models, a copy whose float32
    weights with ndim >= 2 (Dense kernels, embedding tables, the lm_head)
    are pre-cast to bf16 once, as the JAX package does before its loop, and
    so are the biases of the Dense layers that compute in bf16 (each call
    would cast them to bf16 again: the same values, bit for bit). Norm
    parameters stay fp32, and the lm_head then runs in fp32 on
    bf16-rounded weights and its fp32 bias. The copy leaves out the
    alignment head, which decoding never runs. A model with no such
    parameter left is returned as is.
    """
    cast = [p for p in model.parameters() if p.dtype == torch.float32 and p.ndim >= 2]
    cast += [m.bias for m in model.modules()
             if isinstance(m, Dense) and m.dtype == torch.bfloat16 and m.bias is not None
             and m.bias.dtype == torch.float32]
    if model.config.compute_dtype != torch.bfloat16 or not cast:
        return model
    memo = {id(p): torch.nn.Parameter(p.detach().to(torch.bfloat16), requires_grad=False)
            for p in cast}
    if model.align_network is not None:
        memo[id(model.align_network)] = None
    if model.mesh is not None:
        memo[id(model.mesh)] = model.mesh      # its process groups are shared, not copied
    return copy.deepcopy(model, memo)


def collectives_capturable(model: Seq2SeqModel, mesh=None) -> bool:
    """Whether a step's collectives can be captured in a CUDA graph: each
    group either has none to run or runs over NCCL. A decode step runs the
    model group's (``model.mesh``); a train step also sums over the data
    group of ``mesh``, the trainer's."""
    groups = []
    if model.mesh is not None and model.mesh.n_model > 1:
        groups.append(model.mesh.model_group)
    if mesh is not None and mesh.n_model > 1:
        groups.append(mesh.model_group)
    if mesh is not None and mesh.n_data > 1:
        groups.append(mesh.data_group)
    return all(dist.get_backend(group) == "nccl" for group in groups)


def kv_cache_quantized(cfg, num_beams: int, max_length: int) -> bool:
    """The JAX package's int8-cache decision (so both pick the same cache)."""
    head_dim = cfg.d_model // cfg.decoder_attention_heads
    return (
        cfg.kv_cache_dtype == "int8"
        and 4 <= num_beams <= 32
        and cfg.d_model % 128 == 0
        and head_dim % 64 == 0
        and (max_length * num_beams) % 32 == 0
        and max_length * num_beams >= 64
        and not cfg.relative_position_bias
        and cfg.use_beam_kernel
    )


def stage_bounds(stage_size: Optional[int], max_length: int) -> List[int]:
    """Stage bounds (stage_size, 2*stage_size, ..., max_length): each stage
    attends a cache prefix of its bound's length; stages never change
    results."""
    if stage_size is None or stage_size >= max_length:
        return [max_length]
    return list(range(stage_size, max_length, stage_size)) + [max_length]


class _Decode:
    """The static buffers of one decode shape (self caches, cross K/V and
    bias, the loop state, constants) and, on a CUDA device, the captured
    step of each stage with the kernel launches its capture recorded."""

    def __init__(self, dmodel: Seq2SeqModel, batch: int, beams: int, max_length: int,
                 bounds: List[int], encoder_hidden: torch.Tensor, encoder_mask: torch.Tensor,
                 hook_init: Optional[Dict[str, torch.Tensor]]):
        cfg = dmodel.config
        device = encoder_hidden.device
        self.bounds = bounds
        self.cache = dmodel.init_beam_cache(batch, beams, max_length, encoder_hidden,
                                            encoder_mask,
                                            kv_cache_quantized(cfg, beams, max_length))
        seqs = torch.empty((batch, beams, max_length), dtype=torch.long, device=device)
        scores = torch.empty((batch, beams), device=device)
        self.state: Dict[str, Any] = {
            "t": torch.zeros((), dtype=torch.long, device=device),
            "done": torch.zeros((), dtype=torch.bool, device=device),
            "live_seqs": seqs, "live_scores": scores,
            "finished_seqs": torch.empty_like(seqs), "finished_scores": torch.empty_like(scores),
            "ancestry": torch.empty((batch, beams, max_length), dtype=torch.int32,
                                    device=device),
            "hook": {name: torch.empty_like(leaf) for name, leaf in (hook_init or {}).items()},
        }
        self.times = torch.arange(max_length, device=device)
        self.beam_ids = torch.arange(beams, dtype=torch.int32, device=device)
        self.eos_only = torch.full((cfg.vocab_size,), NEG_INF, device=device)
        self.eos_only[cfg.eos_token_id] = 0.0
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, Dict[Callable, int]]] = {}

    def load(self, dmodel: Seq2SeqModel, encoder_hidden, encoder_mask, hook_init) -> None:
        """This request's encoder K/V and bias and its initial state, copied
        into the static buffers. The self caches are not cleared: a step at
        time t reads only rows of times <= t, all written in this request
        (a step run past the exit rewrites its own time's rows, which no
        step that counts reads)."""
        cfg = dmodel.config
        for (k, v), (k_new, v_new) in zip(self.cache["cross"],
                                          dmodel.decoder.project_cross_kv(encoder_hidden)):
            k.copy_(k_new)
            v.copy_(v_new)
        self.cache["cross_bias"].copy_(make_attention_bias(encoder_mask)[:, 0, 0])
        s = self.state
        s["t"].zero_()
        s["done"].zero_()
        s["live_seqs"].fill_(cfg.pad_token_id)
        s["live_seqs"][:, :, 0] = cfg.decoder_start_token_id
        s["live_scores"].fill_(NEG_INF)
        s["live_scores"][:, 0] = 0.0
        s["finished_seqs"].fill_(cfg.pad_token_id)
        s["finished_scores"].fill_(NEG_INF)
        s["ancestry"].zero_()
        for name, leaf in (hook_init or {}).items():
            s["hook"][name].copy_(leaf)


class BeamDecoder:
    """Beam search with one model: its decode copy (:func:`decode_model`)
    and, per decode shape (batch, beams, max length, stages, encoder length,
    logits hook), the static buffers and, on a CUDA device, the captured
    step of each stage, kept for the decoder's life. :meth:`refresh` copies
    the model's current weights into the decode copy in place, so that the
    graphs, which hold its addresses, decode with them."""

    def __init__(self, model: Seq2SeqModel):
        self.model = model
        self.dmodel = decode_model(model)
        self._decodes: Dict[tuple, _Decode] = {}

    def refresh(self) -> None:
        """The model's weights into the decode copy, in place (bf16 casts by
        ``copy_``, as ``decode_model`` casts them). A no-op when the model
        decodes as it is."""
        if self.dmodel is self.model:
            return
        sources = dict(self.model.named_parameters())
        sources.update(self.model.named_buffers())
        with torch.no_grad():
            for name, dst in [*self.dmodel.named_parameters(), *self.dmodel.named_buffers()]:
                dst.copy_(sources[name])

    # ---------------------------------------------------------------- step
    def _step(self, d: _Decode, bound: int, max_length: int, length_penalty: float,
              logits_hook: Optional[Callable]) -> None:
        """One decode step of the stage ending at ``bound``, in place on the
        state; a no-op (state and ``t`` kept) once the decode is done or
        ``t`` has reached ``bound - 1``."""
        s = d.state
        t = s["t"]
        live_seqs, live_scores = s["live_seqs"], s["live_scores"]
        batch, beams, length = live_seqs.shape
        eos = self.dmodel.config.eos_token_id

        # The JAX cond_fn: a live beam's best reachable score is sum / max_length.
        best_live = live_scores.max(dim=1).values / float(max_length) ** length_penalty
        done = (s["finished_scores"].min(dim=1).values >= best_live).all()
        freeze = done | (t >= bound - 1)

        # This step's K/V rows are written at slot = live-beam index.
        ancestry = torch.where(d.times == t, d.beam_ids[:, None], s["ancestry"])
        current = live_seqs.gather(2, t.reshape(1, 1, 1).expand(batch, beams, 1))[..., 0]
        logits = self.dmodel.beam_decode_step(current, t, d.cache, ancestry[:, :, :bound])
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        hook_state = s["hook"]
        if logits_hook is not None:
            hook_state, logprobs = logits_hook(hook_state, logprobs, live_seqs, t)
        logprobs = torch.where(t == max_length - 2, d.eos_only, logprobs)
        vocab = logprobs.shape[-1]

        total = (live_scores[:, :, None] + logprobs).reshape(batch, beams * vocab)
        topk_scores, topk_idx = _top_k(total, 2 * beams)
        topk_beam = topk_idx // vocab
        topk_token = topk_idx % vocab
        cand_seqs = live_seqs.gather(1, topk_beam[:, :, None].expand(-1, -1, length))
        column = (t + 1).clamp(max=length - 1).reshape(1, 1, 1).expand(batch, 2 * beams, 1)
        cand_seqs = cand_seqs.scatter(2, column, topk_token[:, :, None])
        is_eos = topk_token == eos

        # Finished pool: HF normalises by the length before this EOS.
        norm = (t + 1).float() ** length_penalty
        cand_fin = torch.where(is_eos, topk_scores / norm, NEG_INF)
        finished_scores, fin_idx = _top_k(torch.cat([s["finished_scores"], cand_fin], 1), beams)
        finished_seqs = torch.cat([s["finished_seqs"], cand_seqs], 1).gather(
            1, fin_idx[:, :, None].expand(-1, -1, length))

        # Top-K non-EOS continuations become the live beams; a new beam's
        # history is its parent's (an int32 table gather, not a cache move),
        # and so is its hook state.
        new_scores, live_idx = _top_k(torch.where(is_eos, NEG_INF, topk_scores), beams)
        new_seqs = cand_seqs.gather(1, live_idx[:, :, None].expand(-1, -1, length))
        beam_src = topk_beam.gather(1, live_idx)
        ancestry = ancestry.gather(1, beam_src[:, :, None].expand(-1, -1, length))
        if logits_hook is not None:
            hook_state = {
                name: leaf.gather(1, beam_src.reshape(batch, beams, *(1,) * (leaf.ndim - 2))
                                  .expand(-1, -1, *leaf.shape[2:]))
                for name, leaf in hook_state.items()}

        new = {"t": t + 1, "live_seqs": new_seqs, "live_scores": new_scores,
               "finished_seqs": finished_seqs, "finished_scores": finished_scores,
               "ancestry": ancestry}
        for name, value in new.items():
            s[name].copy_(torch.where(freeze, s[name], value))
        for name, value in hook_state.items():
            s["hook"][name].copy_(torch.where(freeze, s["hook"][name], value))
        s["done"].copy_(done)

    def _capture(self, d: _Decode, run_step: Callable[[int], None]) -> int:
        """Capture the step of every stage as a CUDA graph (one memory pool
        for all): each is first run once eagerly on the capture stream (lazy
        initialisation, shared-memory limits: nothing may allocate or set up
        during capture). Those warm-up steps change the state, which the
        caller loads again. A capture launches nothing, so the launch counts
        it ticked are taken back and recorded per graph, to be added at
        every replay. Returns the warm-up steps run."""
        stream = torch.cuda.Stream(device=d.times.device)
        stream.wait_stream(torch.cuda.current_stream())
        pool = None
        for bound in d.bounds:
            with torch.cuda.stream(stream):
                run_step(bound)
            graph = torch.cuda.CUDAGraph()
            before = _cuda.launch_counts()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    run_step(bound)
                after = _cuda.launch_counts()
            finally:
                for fn, count in before.items():
                    fn.launches = count
            d.graphs[bound] = (graph, {fn: after[fn] - before[fn] for fn in after
                                       if after[fn] != before[fn]})
            pool = graph.pool()
        torch.cuda.current_stream().wait_stream(stream)
        return len(d.bounds)

    # -------------------------------------------------------------- search
    @torch.no_grad()
    def search(
        self,
        encoder_inputs: Dict[str, torch.Tensor],
        encoder_mask: torch.Tensor,
        num_beams: int,
        max_length: int = 128,
        length_penalty: float = 1.0,
        stage_size: Optional[int] = 32,
        logits_hook: Optional[Callable] = None,
        hook_init: Optional[Dict[str, torch.Tensor]] = None,
        cuda_graph: bool = True,
        check_every: int = 8,
        stats: Optional[Dict[str, Any]] = None,
        idle: Optional[Callable[[], bool]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (sequences (B, K, max_length) int64, scores (B, K) fp32).

        Sequences start with BOS and are padded after EOS; beams are sorted
        best-first by normalised score. ``stage_size`` decodes in stages
        whose attended cache prefix grows (:func:`stage_bounds`).

        ``logits_hook(state, logprobs, live_seqs, t) -> (state, logprobs)``
        adjusts the log-probs after ``log_softmax`` and before forced EOS
        (the JAX protocol; ``t`` is a 0-d device tensor); ``hook_init`` is
        its state, a dict of (B, K, ...) tensors on the device, whose rows
        are reordered with the beams every step.

        On a CUDA device with ``cuda_graph`` (the default) each stage's step
        is replayed from a CUDA graph, captured at the first decode of this
        shape; a capture that fails raises. A hook whose ``capturable``
        attribute is False (the exact formula hook, which makes one host
        call per step), or a model group whose collectives cannot be
        captured (:func:`collectives_capturable`), runs the step eagerly, as
        ``cuda_graph=False`` does.
        The host reads the ``done`` flag once every ``check_every`` steps.
        ``idle``, if given, is other host work done before each read: one
        piece per call, returning False once none is left. On a CUDA device
        it is called for as long as the steps dispatched since the last read
        are still running (an event query between pieces), elsewhere once.

        ``stats``, if given, receives ``steps`` (the device ``t`` at the end:
        the decode steps that counted, as the JAX loop counts them),
        ``replays`` (the steps run, replays past the exit included),
        ``warmup_steps`` (eager steps of a capture), ``graph`` (whether
        graphs ran), ``capture_s`` and ``dispatch_s`` (host seconds spent
        capturing and launching the steps).
        """
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        device = encoder_mask.device
        use_graph = (cuda_graph and device.type == "cuda"
                     and getattr(logits_hook, "capturable", True)
                     and collectives_capturable(self.model))
        batch = encoder_mask.shape[0]
        bounds = stage_bounds(stage_size, max_length)
        # The encoder runs on the model's own weights, as the JAX package
        # encodes before its pre-cast: its Dense layers round them to bf16
        # per call all the same, and fp32 tables (learned positions, T5's
        # relative bias) stay fp32.
        encoder_hidden = self.model.encode(encoder_inputs, encoder_mask)
        key = (batch, num_beams, max_length, float(length_penalty), tuple(bounds),
               tuple(encoder_hidden.shape), encoder_hidden.dtype, logits_hook,
               tuple((n, tuple(v.shape), v.dtype) for n, v in sorted((hook_init or {}).items())))
        d = self._decodes.get(key)
        if d is None:
            d = self._decodes[key] = _Decode(self.dmodel, batch, num_beams, max_length, bounds,
                                             encoder_hidden, encoder_mask, hook_init)
        d.load(self.dmodel, encoder_hidden, encoder_mask, hook_init)

        def run_step(bound: int) -> None:
            self._step(d, bound, max_length, length_penalty, logits_hook)

        capture_s, warmup_steps = 0.0, 0
        if use_graph and not d.graphs:
            t0 = time.perf_counter()
            try:
                warmup_steps = self._capture(d, run_step)
            except BaseException:
                del self._decodes[key]     # no half-captured shape is kept
                raise
            torch.cuda.synchronize(device)
            capture_s = time.perf_counter() - t0
            d.load(self.dmodel, encoder_hidden, encoder_mask, hook_init)

        replays, since_check, dispatch_s, t_host = 0, 0, 0.0, 0
        for bound in bounds:
            if use_graph:
                graph, launches = d.graphs[bound]

                def step(graph=graph, launches=launches) -> None:
                    graph.replay()
                    for fn, count in launches.items():
                        fn.launches += count
            else:
                def step(bound=bound) -> None:
                    run_step(bound)
            exited = False
            for _ in range(bound - 1 - t_host):
                t0 = time.perf_counter()
                step()
                dispatch_s += time.perf_counter() - t0
                replays += 1
                since_check += 1
                if since_check == check_every:
                    since_check = 0
                    if idle is not None:
                        _idle_while_running(idle, device)
                    if bool(d.state["done"]):
                        exited = True
                        break
            if exited:
                break
            t_host = bound - 1

        s = d.state
        if stats is not None:
            stats.update(steps=int(s["t"]), replays=replays, warmup_steps=warmup_steps,
                         graph=use_graph, capture_s=capture_s, dispatch_s=dispatch_s)
        # Surviving live beams compete with the finished pool.
        live_norm = float(max_length) ** length_penalty
        merged_scores = torch.cat([s["finished_scores"], s["live_scores"] / live_norm], 1)
        merged_seqs = torch.cat([s["finished_seqs"], s["live_seqs"]], 1)
        final_scores, final_idx = _top_k(merged_scores, num_beams)
        final_seqs = merged_seqs.gather(1, final_idx[:, :, None].expand(-1, -1, max_length))
        return final_seqs, final_scores


def _idle_while_running(idle: Callable[[], bool], device: torch.device) -> None:
    """``idle()`` until the work queued on ``device``'s current stream has
    run, or until it has nothing left to do; once where the device is not
    a CUDA device (its steps ran as they were called)."""
    if device.type != "cuda":
        idle()
        return
    ready = torch.cuda.Event()
    ready.record()
    while not ready.query() and idle():
        pass


def beam_search(
    model: Seq2SeqModel,
    encoder_inputs: Dict[str, torch.Tensor],
    encoder_mask: torch.Tensor,
    num_beams: int,
    max_length: int = 128,
    length_penalty: float = 1.0,
    stage_size: Optional[int] = 32,
    stats: Optional[Dict[str, Any]] = None,
    logits_hook: Optional[Callable] = None,
    hook_init: Optional[Dict[str, torch.Tensor]] = None,
    cuda_graph: bool = True,
    check_every: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode with a decoder of its own (:meth:`BeamDecoder.search`, whose
    arguments these are): on a CUDA device its graphs are captured for this
    call and dropped after it. Callers that decode many batches keep a
    :class:`BeamDecoder`."""
    return BeamDecoder(model).search(
        encoder_inputs, encoder_mask, num_beams, max_length=max_length,
        length_penalty=length_penalty, stage_size=stage_size, logits_hook=logits_hook,
        hook_init=hook_init, cuda_graph=cuda_graph, check_every=check_every, stats=stats)


def greedy_decode(model: Seq2SeqModel, encoder_inputs, encoder_mask,
                  max_length: int = 128) -> torch.Tensor:
    """Greedy decoding = beam search with one beam; returns (B, max_length)."""
    seqs, _ = beam_search(model, encoder_inputs, encoder_mask, num_beams=1,
                          max_length=max_length)
    return seqs[:, 0, :]
