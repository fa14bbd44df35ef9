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

A decode is three parts on static buffers: the prologue (the encoder, the
cross K/V projection, the state reset), the steps, and the epilogue (the
final merge into static outputs, which the search returns copies of). On a
CUDA device each part is captured once per shape as a CUDA graph
(:class:`BeamDecoder` keeps the static buffers and an ``ops/_cuda.py``
``GraphSet`` per shape), as ``jax.jit`` compiles the JAX package's whole
decode: the prologue is replayed once, then each stage's step
``bound - 1 - t0`` times, the host reading ``done`` once every
``check_every`` replays and skipping the rest of the decode once it is set
(one graph per stage, as the JAX package runs one ``while_loop`` per
stage), then the epilogue. Elsewhere, or with
``cuda_graph=False``, the same parts run eagerly in the same loop.

With the recorder of ``tracing`` on, a search's host work is spans:
``beam.load`` (the request into the static inputs), ``beam.capture`` (a
shape's first decode), ``beam.prologue``, ``beam.dispatch`` (each run of up
to ``check_every`` steps launched between two reads of ``done``),
``beam.done_wait`` (each read, which waits for the device) and
``beam.epilogue``. On a CUDA device three events per decode shape mark,
on the stream, the prologue's start and end and the last step's end;
:func:`read_device_times` turns them into device milliseconds once the
caller has waited for the device.

Under tensor parallelism (a model built on a mesh with a model axis) each
rank decodes with its slices: the decode copy and :meth:`BeamDecoder.refresh`
keep them, the self caches hold its heads, and the step's sums over the
model group (attention and FFN outputs, the gathered logits) run inside the
step, so every rank's state is the same. A stage's step is captured as a
CUDA graph only where those sums can be captured: when the model group's
backend is NCCL. Under gloo (ranks sharing one card, or the CPU) the steps
run eagerly; ``stats["graph"]`` and ``stats["eager_reason"]`` say which
route ran (``_cuda.graph_route``).

Ties in every top-k break toward the lower index, as ``jax.lax.top_k`` does
(a stable descending sort), so fp32 runs pick the beams the JAX package
picks. The JAX package's rounding of stage sizes to its kernel's tiling is
not needed.
"""

from __future__ import annotations

import copy
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import tracing
from ..models.seq2seq import Seq2SeqModel
from ..ops import _cuda, beam_attention, flash_attention
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
    """The static buffers of one decode shape (the request's encoder inputs,
    mask and hook state, the self caches, cross K/V and bias, the loop
    state, the outputs, constants) and its graph set: on a CUDA device the
    captured prologue, step of each stage and epilogue, by "prologue", each
    stage's bound and "epilogue", checked against ``weights`` (the
    addresses of the weights they read)."""

    def __init__(self, dmodel: Seq2SeqModel, batch: int, beams: int, max_length: int,
                 bounds: List[int], encoder_inputs: Dict[str, Any], encoder_mask: torch.Tensor,
                 hook_init: Optional[Dict[str, torch.Tensor]],
                 weights: Callable[[], Tuple[int, ...]]):
        cfg = dmodel.config
        device = encoder_mask.device
        self.bounds = bounds
        # What search copies each request into, and the prologue reads.
        self.inputs = _cuda.static_like(encoder_inputs)
        self.mask = torch.empty_like(encoder_mask)
        self.hook_init = _cuda.static_like(hook_init or {})
        # Cross K/V of the request's length (each prologue writes its own
        # over them), sized by projecting a zero encoder output once.
        zeros = torch.zeros((batch, encoder_mask.shape[1], cfg.d_model), dtype=cfg.compute_dtype,
                            device=device)
        self.cache = dmodel.init_beam_cache(batch, beams, max_length, zeros, encoder_mask,
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
        self.out_seqs, self.out_scores = torch.empty_like(seqs), torch.empty_like(scores)
        self.times = torch.arange(max_length, device=device)
        self.beam_ids = torch.arange(beams, dtype=torch.int32, device=device)
        self.eos_only = torch.full((cfg.vocab_size,), NEG_INF, device=device)
        self.eos_only[cfg.eos_token_id] = 0.0
        # On a CUDA device: the prologue's start and end and the last
        # step's end, recorded on the stream by each search of this shape.
        self.events = (tuple(torch.cuda.Event(enable_timing=True) for _ in range(3))
                       if device.type == "cuda" else ())
        self.graphs = _cuda.GraphSet(device, weights=weights)
        # The routes this shape's parts take (:meth:`counted`).
        self.prologue_flash_launches = 0
        self.cross_forms = dict.fromkeys(beam_attention.CROSS_FORMS, 0)

    def counted(self, part: Any, run: Callable[[], None]) -> None:
        """``run()``, the prologue or a stage's step, recording the route it
        takes as the kernel wrappers count it: the flash forward's launches
        over the prologue, ``beam_cross_attention``'s calls by form over the
        first stage's step. Under a capture that is what every replay of the
        graph launches."""
        flash, forms = (flash_attention.flash_attention_fwd.launches,
                        dict(beam_attention.beam_cross_attention.forms))
        run()
        if part == "prologue":
            self.prologue_flash_launches = flash_attention.flash_attention_fwd.launches - flash
        elif part == self.bounds[0]:
            self.cross_forms = {form: beam_attention.beam_cross_attention.forms[form] - n
                                for form, n in forms.items()}

    def load(self, encoder_inputs: Dict[str, Any], encoder_mask: torch.Tensor,
             hook_init: Optional[Dict[str, torch.Tensor]]) -> None:
        """This request's tensors into the static inputs, one copy per leaf."""
        _cuda.copy_tree_(self.inputs, encoder_inputs)
        _cuda.copy_tree_(self.mask, encoder_mask)
        _cuda.copy_tree_(self.hook_init, hook_init or {})


class BeamDecoder:
    """Beam search with one model: its decode copy (:func:`decode_model`)
    and, per decode shape (batch, beams, max length, stages, the encoder
    inputs' and mask's structure, shapes and dtypes, logits hook and its
    state's), the static buffers and, on a CUDA device, the captured
    prologue, step of each stage and epilogue, kept for the decoder's life.
    :meth:`refresh` copies the model's current weights into the decode copy
    in place, so that the graphs, which hold its addresses, decode with
    them."""

    def __init__(self, model: Seq2SeqModel):
        self.model = model
        self.dmodel = decode_model(model)
        self._decodes: Dict[tuple, _Decode] = {}
        # The addresses of the weights the graphs read: the model's (the
        # encoder) and the decode copy's (the steps).
        modules = (model,) if self.dmodel is model else (model, self.dmodel)
        self._weights = functools.partial(_cuda.addresses, *modules)

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

    def graph_pool_bytes(self) -> int:
        """Device bytes held by the memory pools of the captured decodes
        (one per shape: what the prologue, the steps and the epilogue keep
        between requests)."""
        return sum(d.graphs.pool_bytes() for d in self._decodes.values())

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

    # ------------------------------------------------- prologue, epilogue
    def _prologue(self, d: _Decode) -> None:
        """The decode's start, on the static inputs: the encoder, the
        cross K/V projected into the cache, the cross bias and the loop
        state reset. The encoder runs on the model's own weights, as the
        JAX package encodes before its pre-cast: its Dense layers round
        them to bf16 per call all the same, and fp32 tables (learned
        positions, T5's relative bias) stay fp32. The self caches are not
        cleared: a step at time t reads only rows of times <= t, all
        written in this request (a step run past the exit rewrites its own
        time's rows, which no step that counts reads)."""
        cfg = self.dmodel.config
        hidden = self.model.encode(d.inputs, d.mask)
        self.dmodel.decoder.project_cross_kv(hidden, out=d.cache["cross"])
        d.cache["cross_bias"].copy_(make_attention_bias(d.mask)[:, 0, 0])
        s = d.state
        s["t"].zero_()
        s["done"].zero_()
        s["live_seqs"].fill_(cfg.pad_token_id)
        s["live_seqs"][:, :, 0] = cfg.decoder_start_token_id
        s["live_scores"].fill_(NEG_INF)
        s["live_scores"][:, 0] = 0.0
        s["finished_seqs"].fill_(cfg.pad_token_id)
        s["finished_scores"].fill_(NEG_INF)
        s["ancestry"].zero_()
        for name, leaf in d.hook_init.items():
            s["hook"][name].copy_(leaf)

    @staticmethod
    def _epilogue(d: _Decode, max_length: int, length_penalty: float) -> None:
        """The decode's end: surviving live beams compete with the finished
        pool, the best ``K`` written into the static outputs."""
        s = d.state
        live_norm = float(max_length) ** length_penalty
        merged_scores = torch.cat([s["finished_scores"], s["live_scores"] / live_norm], 1)
        merged_seqs = torch.cat([s["finished_seqs"], s["live_seqs"]], 1)
        scores, idx = _top_k(merged_scores, d.out_scores.shape[1])
        d.out_scores.copy_(scores)
        d.out_seqs.copy_(merged_seqs.gather(1, idx[:, :, None].expand(-1, -1, max_length)))

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
        """Returns (sequences (B, K, max_length) int64, scores (B, K) fp32),
        new tensors of this call's own.

        Sequences start with BOS and are padded after EOS; beams are sorted
        best-first by normalised score. ``stage_size`` decodes in stages
        whose attended cache prefix grows (:func:`stage_bounds`).

        ``logits_hook(state, logprobs, live_seqs, t) -> (state, logprobs)``
        adjusts the log-probs after ``log_softmax`` and before forced EOS
        (the JAX protocol; ``t`` is a 0-d device tensor); ``hook_init`` is
        its state, a dict of (B, K, ...) tensors on the device, whose rows
        are reordered with the beams every step.

        The request's tensors are copied into the decode shape's static
        inputs; the prologue (encoder, cross K/V, state reset), each
        stage's step and the epilogue (the final merge) read and write
        only static buffers. On a CUDA device with ``cuda_graph`` (the
        default) each of them is replayed from a CUDA graph, captured at
        the first decode of this shape (of its inputs' structure, shapes
        and dtypes), as ``jax.jit`` compiles the JAX package's whole
        decode; a capture that fails raises. A shape whose weights have
        moved since its capture (a parameter rebound) is captured again. A
        hook whose ``capturable`` attribute is False (the exact formula
        hook, which makes one host call per step), or a model group whose
        collectives cannot be captured, runs every part eagerly, as
        ``cuda_graph=False`` does (``_cuda.graph_route``).
        The host reads the ``done`` flag once every ``check_every`` steps.
        ``idle``, if given, is other host work done before each read: one
        piece per call, returning False once none is left. On a CUDA device
        it is called for as long as the steps dispatched since the last read
        are still running (an event query between pieces), elsewhere once.

        ``stats``, if given, receives ``steps`` (the device ``t`` at the end:
        the decode steps that counted, as the JAX loop counts them),
        ``replays`` (the steps run, replays past the exit included),
        ``warmup_steps`` (eager steps of a capture), ``graph`` (whether
        the graphs ran), ``eager_reason`` (None if they did, otherwise why
        not), ``recaptured`` (whether this shape was captured again for
        moved weights), ``capture_s`` and
        ``dispatch_s`` (host seconds spent capturing and launching the
        steps), ``prologue_flash_launches`` (the flash forward's launches in
        a prologue: one per encoder layer that takes flash, 0 where the
        plain route runs) and ``cross_forms`` (``beam_cross_attention``'s
        calls by form in a step of the first stage: one per decoder layer,
        in the form its plan picked; all 0 off a CUDA device), as the
        shape's captures recorded them or this search's eager parts ran
        them, and, on a CUDA device, ``events``: the decode shape's three
        events, which :func:`read_device_times` reads once the device has
        run the search (the search itself waits for no more than its
        ``done`` reads) and before the next search of the shape.
        """
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        device = encoder_mask.device
        route = _cuda.graph_route(device, cuda_graph, self.model, hook=logits_hook)
        batch = encoder_mask.shape[0]
        bounds = stage_bounds(stage_size, max_length)
        key = (batch, num_beams, max_length, float(length_penalty), tuple(bounds),
               _cuda.signature(encoder_inputs), _cuda.signature(encoder_mask), logits_hook,
               _cuda.signature(hook_init or {}))
        d = self._decodes.get(key)
        if d is None:
            d = self._decodes[key] = _Decode(self.dmodel, batch, num_beams, max_length, bounds,
                                             encoder_inputs, encoder_mask, hook_init,
                                             self._weights)
        with tracing.span("beam.load"):
            d.load(encoder_inputs, encoder_mask, hook_init)

        parts = {"prologue": functools.partial(self._prologue, d),
                 **{bound: functools.partial(self._step, d, bound, max_length, length_penalty,
                                             logits_hook) for bound in bounds},
                 "epilogue": functools.partial(self._epilogue, d, max_length, length_penalty)}
        capture_s, warmup_steps, recaptures = 0.0, 0, d.graphs.recaptures
        if route is None and d.graphs.get("prologue") is None:
            # Each part in order, after a warm-up run that changes the
            # state, which the prologue's replay resets.
            t0 = time.perf_counter()
            with tracing.span("beam.capture"):
                try:
                    for part, fn in parts.items():
                        d.graphs.capture(part, functools.partial(d.counted, part, fn), warm=True)
                except BaseException:
                    del self._decodes[key]     # no half-captured shape is kept
                    raise
                torch.cuda.synchronize(device)
            capture_s, warmup_steps = time.perf_counter() - t0, len(bounds)
        run = {part: (functools.partial(d.graphs.replay, d.graphs.entries[part]) if route is None
                      else functools.partial(d.counted, part, fn)) for part, fn in parts.items()}

        events = d.events if stats is not None else ()
        if events:
            events[0].record()
        with tracing.span("beam.prologue"):
            run["prologue"]()
        if events:
            events[1].record()
        # The stage of each replay, in order: bound - prev replays of the
        # stage ending at bound (times prev - 1 to bound - 2), prev the
        # bound before it (1 before the first).
        order = [bound for bound, prev in zip(bounds, [1] + bounds[:-1])
                 for _ in range(bound - prev)]
        replays, dispatch_s = 0, 0.0
        for first in range(0, len(order), check_every):
            steps = order[first:first + check_every]
            with tracing.span("beam.dispatch"):
                for bound in steps:
                    t0 = time.perf_counter()
                    run[bound]()
                    dispatch_s += time.perf_counter() - t0
            replays += len(steps)
            if len(steps) < check_every:
                break
            if idle is not None:
                _idle_while_running(idle, device)
            with tracing.span("beam.done_wait"):
                done = bool(d.state["done"])
            if done:
                break
        if events:
            events[2].record()
        with tracing.span("beam.epilogue"):
            run["epilogue"]()

        if stats is not None:
            stats.update(steps=int(d.state["t"]), replays=replays, warmup_steps=warmup_steps,
                         graph=route is None, eager_reason=route,
                         recaptured=d.graphs.recaptures > recaptures, capture_s=capture_s,
                         dispatch_s=dispatch_s, prologue_flash_launches=d.prologue_flash_launches,
                         cross_forms=dict(d.cross_forms))
            if events:
                stats["events"] = events
        return d.out_seqs.clone(), d.out_scores.clone()


def read_device_times(stats: Dict[str, Any]) -> None:
    """Into a search's ``stats``, once the device has run that search and
    before the next search of its shape: ``prologue_ms`` (the encoder, the
    cross K/V projection and the state reset) and ``steps_ms`` (from the
    prologue's end to the last step's, the waits between steps included),
    device milliseconds from its ``events``, which it removes. Stats
    without them (a search off a CUDA device) are left as they are."""
    events = stats.pop("events", None)
    if events:
        start, prologue_end, steps_end = events
        stats["prologue_ms"] = start.elapsed_time(prologue_end)
        stats["steps_ms"] = prologue_end.elapsed_time(steps_end)


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
