"""Training steps through ``Trainer.fit`` on the replayed train-step graph.

One trainer (model, AdamW state, the graph) is built in set-up and driven
from the seed through its first three steps by ``fit`` on the pool's first
three batches (the first step eager, the second captured and replayed, the
third replayed); the window's ``fit`` then takes the pool's batches in turn
from a generator that stops when the window ends. The check: the three
steps' losses, each parameter's gradient at step 1 as the optimizer took it
(its first moment over 1 - beta1) and each parameter's change after step 3,
against the reference's three steps from the same weights on the same
batches with the same dropout masks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

from ..harness import common
from ..harness.spans import Spans
from ..harness.trace import Stretch
from ..reference.check import train_gaps, train_readings
from ..traffic import inputs


def _batches(config, traffic, seed):
    encoder = inputs.encoder_pool(config, traffic, seed)
    targets = inputs.target_pool(config, traffic, seed)
    return [{"encoder_inputs": x, "encoder_mask": m, **t} for (x, m), t in zip(encoder, targets)]


def run(ctx, log: Callable[[str], None]) -> Dict[str, Any]:
    from multimodalanalytical_tpu_torch.training import Trainer

    from ..harness import model as model_maker

    config, traffic = ctx.config, ctx.traffic
    m, settings = config["model"], config["trainer"]
    model, weights = model_maker.build(config, ctx.seed, ctx.device)
    weights = common.host_weights(weights)
    trainer = Trainer(model, optimiser=m["optimiser"], lr=m["lr"],
                      weight_decay=m["weight_decay"], adam_beta1=m["adam_beta1"],
                      adam_beta2=m["adam_beta2"], num_steps=settings["num_steps"],
                      acc_batches=settings["acc_batches"], clip_grad=settings["clip_grad"],
                      seed=ctx.seed)
    batches = _batches(config, traffic, ctx.seed)
    fed_batches = batches
    if ctx.fault == "half_batch":
        fed_batches = [dict(b, labels=b["labels"].copy()) for b in batches]
        for b in fed_batches:
            b["labels"][len(b["labels"]) // 2:] = -100
    elif ctx.fault == "state_unchanged":
        trainer.optimizer._update = lambda grads: None
    spans = Spans(enabled=ctx.trace)
    trainer.train_step = spans.wrap("train_step", trainer.train_step)
    fed = []

    def feed(count: int = 0, deadline: float = 0.0) -> Iterator[Dict[str, Any]]:
        start = len(fed)
        while (len(fed) - start < count) if count else (common.now() < deadline):
            fed.append(len(fed) % len(batches))
            yield fed_batches[fed[-1]]

    names = [name for name, _ in model.named_parameters()]
    losses = trainer.fit(feed(count=1), epochs=1)
    beta1 = m["adam_beta1"]
    grads = {n: float(mu.norm()) / (1.0 - beta1) for n, mu in zip(names, trainer.optimizer.mu)}
    losses += trainer.fit(feed(count=2), epochs=1)
    change = {n: p.detach().cpu() - weights[n] for n, p in zip(names, trainer.params)}
    common.sync(ctx.device)
    setup_s = common.now() - ctx.t_start
    log(f"set-up {setup_s:.3f} s: train step captured in "
        f"{trainer.step_stats['capture_s']:.3f} s ({trainer.step_stats})")

    first = len(fed)
    t0 = common.now()
    window_losses = trainer.fit(feed(deadline=t0 + ctx.seconds), epochs=1)
    window_s = common.now() - t0
    window = fed[first:]
    summary = None
    if ctx.trace:
        spans.enabled = True
        with Stretch(spans) as stretch:
            trainer.fit(feed(count=traffic["trace_steps"]), epochs=1)
        summary = stretch.summary()
    peak = common.memory_peak(ctx.device)
    finite = all(x == x and abs(x) != float("inf") for x in window_losses)
    del trainer, model
    common.free(ctx.device)

    control = None
    with common.fp32_matmuls():
        device_weights = {n: t.to(ctx.device) for n, t in weights.items()}
        first3 = [common.to_device(batches[i], ctx.device) for i in range(3)]
        want = train_readings(device_weights, config, first3, ctx.seed)
        gaps = train_gaps({"losses": losses[:3], "grad_norms": grads, "change": change}, want)
        if ctx.control:
            control = {}
            for name, kwargs in (("fp8", {"fp8": True}), ("half_batch", {"half_batch": True})):
                other = train_readings(device_weights, config, first3, ctx.seed, **kwargs)
                other["grad_norms"] = {n: float(g.norm()) for n, g in other["grads"].items()}
                control[name] = train_gaps(other, want)
    log(f"window {window_s:.4f} s: {len(window)} steps of {traffic['batch']}; losses "
        f"{[round(x, 5) for x in losses[:3]]} (reference {[round(x, 5) for x in want['losses']]})")
    limits = traffic["limits"]
    for name in sorted(set(gaps) - set(limits)):
        log(f"not compared {name}: {gaps[name]!r}")
    return {
        "setup_s": setup_s, "window_s": window_s, "attempted": len(window),
        "failed": 0 if finite else len(window), "samples": len(window) * traffic["batch"],
        "train_steps": window, "batches": batches, "config": config, "traffic": traffic,
        "trace": summary, "memory_peak_bytes": peak,
        "checks": {name: (gaps[name], limit) for name, limit in limits.items()},
        "control": control,
    }
