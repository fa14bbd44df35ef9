"""Data parallelism across processes in the port (``parallel/``, the trainer's
data-parallel step, rank-0 checkpoints, per-rank artifacts).

The file is also its own worker: ``python tests/test_torch_multiprocess.py
--worker '<json>'`` runs one rank (or, at world 0, one process with no
group) of the same fit -> validate -> predict as ``tests/multihost_fit_worker.py``
runs it for the JAX package, over gloo on the CPU with a ``file://`` store
in the test's directory (no TCP port). The fit is fp32, dropout 0, with an
align head and modality dropout over both inputs, on 17 rows of varied
target lengths at global batch 8: batches of 8, 8 and 1 rows, so ranks
hold different token counts and, at world 2 and 4, some rank holds no real
row. At world sizes 1, 2 and 4 the per-step losses, gradient norms and
summed gradients, the parameters after the fit's 3 steps, the validation
metrics on every rank and the rank-ordered predictions must equal the
one-process run (rtol RTOL; metrics' counts exactly). A mean of per-rank
mean losses, DDP's default, is shown to fail the same test. Each launch
has its own time limit (``communicate(timeout=...)``).

Each rank then fits twice more into one checkpoint directory shared by the
ranks, with asynchronous saves (the trainer's route) and with the
synchronous route, at a cadence that pins a rate-suppressed best and
flushes it at the end: rank 0 alone writes, no collective runs off a
rank's main thread, and every rank returns the same losses and reads the
same ``best`` and index as the synchronous route and the one-process run.
A save whose write fails on rank 0, asynchronous or not, raises on every
rank (rank 0's own error there, a RuntimeError on the others) rather than
leaving the other ranks waiting in a collective.

The one-process run is itself held against the JAX package's trainer, so
every world size inherits that reference: its loader, collator and
preprocessors give the same global batches, and its train step, started
from the port's initial weights and fed the port's modality-dropped
encoder masks, gives the same per-step losses, gradients and gradient
norms (rtol RTOL), then the same validation metrics and predictions.

Some gradient entries are zero in exact arithmetic: the attention key
biases (softmax is invariant to a shift along the keys) and mae outputs
whose signs cancel over a batch. In floating point they are rounding noise
of the summation order, which differs across world sizes, and Adam scales
noise to a step of the learning rate's size. The parameters are held to
RTOL where every step's gradient is zero or above that noise (NOISE of the
step's gradient norm; fp32 rounds a sum at 6e-8 of its terms), which
leaves out under 1% of them here; the gradients themselves, noise entries
included, are held to RTOL of the step's gradient norm.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more

REPO = Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4)
RTOL, ATOL = 1e-6, 1e-7
NOISE = 1e-8
LAUNCH_TIMEOUT_S = 300
GLOBAL_BATCH = 8
SMILES = ["CCO", "CCN", "CC(=O)Oc1ccccc1C(=O)O", "C", "O=C(O)c1ccccc1", "CCCCCCCC",
          "c1ccncc1", "CC(C)(C)O", "N", "CC(=O)Nc1ccc(O)cc1", "CO", "ClCCl", "CCOC(C)=O",
          "C1CCCCC1", "CC#N", "OCC(O)CO", "Cc1ccccc1"]
SMILES_REGEX = (r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\\\|\/|:"
                r"|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])")
PATCHES = {"patch_size": 50, "interpolation": False, "masking": False}
DATA_CONFIG = {
    "Formula": {"type": "text", "column": "Formula", "target": False,
                "preprocessor_arguments": {"tokenizer_regex": r"([A-Z]{1}[a-z]?[0-9]*)"}},
    "IR": {"type": "1D_patches", "column": "IR", "target": False,
           "preprocessor_arguments": dict(PATCHES)},
    "IR_target": {"type": "1D_patches", "column": "IR_target", "target": True,
                  "alignment": True, "preprocessor_arguments": dict(PATCHES)},
    "Smiles": {"type": "text", "column": "Smiles", "target": True,
               "preprocessor_arguments": {"tokenizer_regex": SMILES_REGEX}},
}


def _columns() -> dict:
    rng = np.random.default_rng(0)
    spectra = [rng.random(200).tolist() for _ in SMILES]
    return {"Formula": [f"C{len(s)}H{2 * len(s)}O" for s in SMILES], "IR": spectra,
            "IR_target": [s[::-1] for s in spectra], "Smiles": list(SMILES)}


def _model_config(config, model_config, align_config):
    """The fit's model, built from either package's config classes."""
    return model_config(
        d_model=32, encoder_layers=1, decoder_layers=1, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
        vocab_size=config["Smiles"]["vocab_size"], pad_token_id=config["Smiles"]["pad_token_id"],
        max_target_length=24, dropout=0.0, dtype="float32",
        align_config=align_config(align_network="convolutional", hidden_dimension=16,
                                  conv_channels=8, kernel_size=5, output_dimension=1800,
                                  loss_lambda=10.0, loss_function="mae"))


# ------------------------------------------------------------------ worker


def _worker(args: dict) -> None:
    import torch.distributed as dist

    from multimodalanalytical_tpu_torch.data.collator import MultiModalCollator
    from multimodalanalytical_tpu_torch.data.data_utils import fit_preprocessors
    from multimodalanalytical_tpu_torch.data.datasets import TableDataset
    from multimodalanalytical_tpu_torch.models.config import AlignConfig, ModelConfig
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel
    from multimodalanalytical_tpu_torch.parallel import multihost
    from multimodalanalytical_tpu_torch.training.checkpoint import (
        CheckpointManager,
        restore_params,
    )
    from multimodalanalytical_tpu_torch.training.loader import DataLoader
    from multimodalanalytical_tpu_torch.training import trainer as trainer_module
    from multimodalanalytical_tpu_torch.training.trainer import Trainer, device_batch

    rank, world, workdir = args["rank"], args["world"], Path(args["workdir"])
    # Every collective and every checkpoint write of this process, by thread.
    off_main, writes = [], []
    for name in ("all_reduce", "barrier"):
        def on_main_thread(*a, _collective=getattr(dist, name), **k):
            if threading.current_thread() is not threading.main_thread():
                off_main.append(threading.current_thread().name)
            return _collective(*a, **k)

        setattr(dist, name, on_main_thread)
    write = CheckpointManager._write

    def recorded_write(self, step, *a):
        writes.append(step)
        return write(self, step, *a)

    CheckpointManager._write = recorded_write
    if world:
        dist.init_process_group("gloo", init_method=f"file://{args['store']}", rank=rank,
                                world_size=world)
        assert multihost.process_count() == world and multihost.process_index() == rank
    shards = max(world, 1)

    table = TableDataset(_columns())
    config, preps = fit_preprocessors(table.columns, json.loads(json.dumps(DATA_CONFIG)))
    collator = MultiModalCollator(preps, config, pad_to_batch_size=GLOBAL_BATCH // shards)
    collator.fit_lengths(table.columns)
    loader_args = dict(num_shards=shards, shard_index=rank, prefetch=0)
    train = DataLoader(table, collator, GLOBAL_BATCH, shuffle=True, seed=7, **loader_args)
    evaluation = DataLoader(table, collator, GLOBAL_BATCH, **loader_args)

    def model():
        cfg = _model_config(config, ModelConfig, AlignConfig)
        return Seq2SeqModel(cfg, config, "Smiles", generator=torch.Generator().manual_seed(0))

    trainer = Trainer(model(), preps["Smiles"], num_steps=6, lr=1e-3, seed=0, n_beams=2,
                      modality_dropout=["Formula", "IR"])

    # Each batch's loss at the initial weights, as the step computes it and
    # as a mean of per-rank means, with each rank's token count.
    first_losses = []
    with torch.no_grad():
        for batch in train:
            dev = device_batch(batch, trainer.device)
            share = trainer.eval_step(dev, trainer.loss_counts(dev["labels"],
                                                               dev["encoder_mask"]))
            local_mean = trainer.eval_step(dev)
            tokens = np.zeros(shards)
            tokens[rank] = int((batch["labels"] != -100).sum())
            first_losses.append({
                "loss": float(multihost.sum_across_processes([float(share["loss"])])[0]),
                "mean_of_means": float(multihost.sum_across_processes(
                    [float(local_mean["loss"])])[0]) / shards,
                "tokens": multihost.sum_across_processes(tokens).tolist()})
    train._epoch = 0

    steps, grads = [], []
    take_step, optimizer_step = trainer.train_step, trainer.optimizer.step

    def recorded_update(step_grads, completes=None):
        grads.append(torch.cat([g.reshape(-1) for g in step_grads]).numpy().copy())
        optimizer_step(step_grads, completes)

    # What the JAX package's trainer needs to take the same steps: the initial
    # weights, each step's host batch and the encoder mask after the modality
    # dropout draw (the draws come from torch's generator, not jax.random).
    anchor = {"names": [n for n, _ in trainer.model.named_parameters()],
              "init": {n: p.detach().numpy().copy()
                       for n, p in trainer.model.named_parameters()},
              "batches": [], "masks": []}
    draw = trainer_module.apply_modality_dropout

    def recorded_draw(*args):
        mask = draw(*args)
        anchor["masks"].append(mask.numpy().copy())
        return mask

    def recorded_step(batch):
        anchor["batches"].append(batch)
        metrics = take_step(batch)
        steps.append({k: float(v) for k, v in metrics.items()})
        return metrics

    trainer.train_step, trainer.optimizer.step = recorded_step, recorded_update
    trainer_module.apply_modality_dropout = recorded_draw
    checkpoints = CheckpointManager(workdir / f"ckpt_rank{rank}")
    trainer.fit(train, evaluation, epochs=1, checkpoints=checkpoints)
    trainer_module.apply_modality_dropout = draw
    if not world:
        with open(workdir / "jax_anchor.pkl", "wb") as f:
            pickle.dump(anchor, f)
    val = trainer.validate(evaluation)
    predictions = trainer.predict(evaluation, n_beams=2)

    # One checkpoint directory for every rank of the run, each route.
    shared = {}
    for route in ("async", "sync"):
        train._epoch = 0
        fit_trainer = Trainer(model(), preps["Smiles"], num_steps=6, lr=1e-3, seed=0, n_beams=2,
                              monitor="val_loss", checkpoint_every_n_vals=3)
        manager = CheckpointManager(workdir / f"shared_{route}", monitor="val_loss", mode="min")
        if route == "sync":
            def sync_save(step, tree, metrics, fresh=(), manager=manager):
                manager.wait()
                manager.save(step, tree, metrics)

            manager.save_async = sync_save
        pinned, flush = [], fit_trainer._flush_pending_best

        def recording_flush(checkpoints, trainer=fit_trainer, flush=flush, pinned=pinned):
            if trainer._pending_best is not None:
                pinned.append(trainer._pending_best[0])
            flush(checkpoints)

        fit_trainer._flush_pending_best = recording_flush
        del writes[:]
        losses = fit_trainer.fit(train, evaluation, epochs=2, checkpoints=manager)
        best = restore_params(workdir / f"shared_{route}" / "best")
        shared[route] = {"losses": losses, "pinned": pinned, "writes": list(writes),
                         "index": manager._index, "best_step": manager.best_step,
                         "best": torch.cat([v.reshape(-1).float() for v in best.values()]
                                           ).numpy()}

    # A write that fails on rank 0: each route's error on every rank.
    failing = CheckpointManager(workdir / "failing")

    def broken_write(step, tree, metrics):
        raise OSError("no space left on device")

    failing._write = broken_write
    failed = {}
    for route, save in (("async", lambda: failing.save_async(1, trainer.state_tree(), {})
                         or failing.wait()),
                        ("sync", lambda: failing.save(2, trainer.state_tree(), {}))):
        try:
            save()
            failed[route] = None
        except Exception as exc:
            failed[route] = f"{type(exc).__name__}: {exc}"

    np.savez(workdir / f"params_rank{rank}.npz", grads=np.stack(grads),
             params=torch.cat([p.detach().reshape(-1) for p in trainer.params]).numpy(),
             **{f"best_{route}": value.pop("best") for route, value in shared.items()})

    # The JAX package's dryrun_multichip at data parallelism: one step with
    # modality dropout on a fixed global batch, then a beam decode (K 2, 8 steps).
    dry = Trainer(model(), preps["Smiles"], num_steps=4, lr=1e-3, seed=0,
                  modality_dropout=["IR"])
    batch = next(iter(evaluation))
    loss = float(dry.train_step(batch)["loss"])
    dev = device_batch(batch, dry.device)
    seqs, scores = dry.beam_decoder().search(dev["encoder_inputs"], dev["encoder_mask"], 2,
                                             max_length=8)
    n_valid = batch["n_valid"]

    ckpt_dir = workdir / f"ckpt_rank{rank}"
    (workdir / f"rank{rank}.json").write_text(json.dumps({
        "first_losses": first_losses, "steps": steps, "val": val,
        "avg_loss": predictions["avg_loss"], "predictions": predictions["predictions"],
        "targets": predictions["targets"],
        "wrote_checkpoints": sorted(p.name for p in ckpt_dir.iterdir()),
        "shared": shared, "failed_saves": failed, "collectives_off_main_thread": off_main,
        "dryrun": {"loss": loss, "seqs": seqs[:n_valid].tolist(),
                   "scores": scores[:n_valid].tolist()}}))
    if world:
        dist.destroy_process_group()


# ------------------------------------------------------------------- tests


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _start(commands, logs, env=None):
    """One process per command, its output into its log file (a pipe that
    nobody reads could block a rank while another waits for it)."""
    procs = []
    for command, log in zip(commands, logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(command, cwd=REPO, env=env or _env(), stdout=out,
                                          stderr=subprocess.STDOUT))
    return procs


def _launch(world: int, workdir: Path):
    """Every rank of one run (world 0: one process, no group)."""
    workdir.mkdir(parents=True)
    ranks = range(max(world, 1))
    commands = [[sys.executable, __file__, "--worker",
                 json.dumps({"rank": r, "world": world, "workdir": str(workdir),
                             "store": str(workdir / "store")})] for r in ranks]
    return _start(commands, [workdir / f"log{r}.txt" for r in ranks])


def _wait(procs, logs, what):
    """Wait for every process within its time limit; kill what is left and
    raise with the log of a process that failed."""
    try:
        for p in procs:
            p.wait(timeout=LAUNCH_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{what} rank {r} failed:\n{Path(log).read_text()[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [per-rank results]} for world 0 (the one-process reference)
    and each world size, all launched together."""
    root = tmp_path_factory.mktemp("multiprocess")
    launched = {w: _launch(w, root / f"world{w}") for w in (0,) + WORLDS}
    try:
        for w, procs in launched.items():
            _wait(procs, [root / f"world{w}" / f"log{r}.txt" for r in range(len(procs))],
                  f"world {w}")
    finally:
        for procs in launched.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    results = {}
    for w in launched:
        results[w] = []
        for r in range(max(w, 1)):
            result = json.loads((root / f"world{w}" / f"rank{r}.json").read_text())
            with np.load(root / f"world{w}" / f"params_rank{r}.npz") as arrays:
                result.update(arrays)
            results[w].append(result)
    with open(root / "world0" / "jax_anchor.pkl", "rb") as f:
        results[0][0]["anchor"] = pickle.load(f)
    return results


@pytest.fixture(scope="module")
def jax_run(runs):
    """The JAX package's trainer on the one-process run's steps: its own
    preprocessors, collator and loader over the same 17 rows (global batch
    8, shuffle seed 7), the port's initial weights carried in, each step's
    encoder mask replaced by the port's after its modality dropout draw (the
    two packages draw from different generators), and its own train step,
    gradients, ``validate`` and ``predict``."""
    jax = pytest.importorskip("jax")
    from multimodalanalytical_tpu.data.collator import MultiModalCollator
    from multimodalanalytical_tpu.data.data_utils import fit_preprocessors
    from multimodalanalytical_tpu.data.datasets import TableDataset
    from multimodalanalytical_tpu.models import AlignConfig, ModelConfig, Seq2SeqModel
    from multimodalanalytical_tpu.parallel.mesh import make_mesh, shard_batch
    from multimodalanalytical_tpu.training import trainer as jax_trainer
    from multimodalanalytical_tpu.training.loader import DataLoader
    from multimodalanalytical_tpu_torch.models.weights import _RENAMES, flax_to_state_dict

    anchor = runs[0][0]["anchor"]
    table = TableDataset(_columns())
    config, preps = fit_preprocessors(table.columns, json.loads(json.dumps(DATA_CONFIG)))
    collator = MultiModalCollator(preps, config, pad_to_batch_size=GLOBAL_BATCH)
    collator.fit_lengths(table.columns)
    train = DataLoader(table, collator, GLOBAL_BATCH, shuffle=True, seed=7, prefetch=0)
    evaluation = DataLoader(table, collator, GLOBAL_BATCH, prefetch=0)
    model = Seq2SeqModel(config=_model_config(config, ModelConfig, AlignConfig),
                         data_config=config, target_modality="Smiles")
    mesh = make_mesh(devices=jax.devices()[:1])
    trainer = jax_trainer.Trainer(model, preps["Smiles"], num_steps=6, lr=1e-3, mesh=mesh,
                                  seed=0, n_beams=2)
    batches = list(train)
    state = trainer.init_state(batches[0])

    # The port also builds an embedding for the align target's modality,
    # which neither package applies and flax therefore never creates.
    leaves, treedef = jax.tree_util.tree_flatten_with_path(state.params)
    carried, applied = [], set()
    for path, leaf in leaves:
        keys = [k.key for k in path]
        name = ".".join(keys[:-1] + [_RENAMES.get(keys[-1], keys[-1])])
        carried.append(anchor["init"][name].T if keys[-1] == "kernel" else anchor["init"][name])
        assert carried[-1].shape == leaf.shape, name
        applied.add(name)
    unapplied = sorted(set(anchor["init"]) - applied)
    assert unapplied and all(n.startswith(("embedding.embed_IR_target.",
                                           "embedding.norm_IR_target.")) for n in unapplied)
    state = trainer.state_with_params(state, jax.tree_util.tree_unflatten(treedef, carried))

    def loss(params, batch):
        return model.apply({"params": params}, batch["encoder_inputs"], batch["encoder_mask"],
                           batch["decoder_ids"], batch["decoder_mask"], batch["labels"],
                           batch["align_target"], deterministic=True)["loss"]

    gradient = jax.jit(jax.grad(loss))
    step = trainer._build_train_step(jax_trainer._modality_segments(
        batches[0]["encoder_inputs"], order=list(config)))
    steps, grads = [], []
    for batch, mask in zip(batches, anchor["masks"]):
        dev = shard_batch(jax_trainer._device_batch(dict(batch, encoder_mask=mask)), mesh)
        named = flax_to_state_dict(jax.device_get(gradient(state.params, dev)))
        grads.append(np.concatenate([
            named[n].reshape(-1) if n in applied else np.zeros(anchor["init"][n].size)
            for n in anchor["names"]]))
        state, metrics = step(state, dev, {})
        steps.append({k: float(v) for k, v in metrics.items()})
    val = trainer.validate(state, evaluation, trainer._build_eval_step())
    predictions = trainer.predict(state, evaluation, n_beams=2)
    return {"batches": batches, "steps": steps, "grads": np.stack(grads), "val": val,
            "avg_loss": predictions["avg_loss"], "predictions": predictions["predictions"],
            "targets": predictions["targets"]}


def _rank_ordered(ranks, key, world):
    """Rank-ordered concat of each global batch's per-rank rows: rank r
    holds rows [offset_r, offset_r + size_r) of every global batch of 8 (the
    loader's split, the remainder to the lowest ranks)."""
    combined, offsets = [], [0] * world
    for rows in (8, 8, 1):
        base, rem = divmod(rows, world)
        for r in range(world):
            count = base + (1 if r < rem else 0)
            combined.extend(ranks[r][key][offsets[r]:offsets[r] + count])
            offsets[r] += count
    return combined


def test_one_process_batches_are_the_jax_loaders(runs, jax_run):
    """The port's loader yields the JAX loader's global batches: 8, 8 and
    one real row padded to 8."""
    got, want = runs[0][0]["anchor"]["batches"], jax_run["batches"]
    assert [b["n_valid"] for b in got] == [b["n_valid"] for b in want] == [8, 8, 1]
    for g, w in zip(got, want):
        assert g["target_strings"] == w["target_strings"]
        for key in ("encoder_mask", "decoder_ids", "decoder_mask", "labels", "align_target"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        for modality in w["encoder_inputs"]:
            np.testing.assert_array_equal(g["encoder_inputs"][modality],
                                          w["encoder_inputs"][modality], err_msg=modality)


def test_one_process_steps_equal_the_jax_trainers(runs, jax_run):
    """Per-step losses, gradients and their norms of the one-process run,
    which every world size is held to, against the JAX trainer's on the
    same weights and batches."""
    ref = runs[0][0]
    for key in ("loss", "model_only_loss", "alignment_loss"):
        np.testing.assert_allclose([s[key] for s in ref["steps"]],
                                   [s[key] for s in jax_run["steps"]], rtol=RTOL, err_msg=key)
    norms = np.linalg.norm(jax_run["grads"], axis=1)
    np.testing.assert_allclose([s["grad_norm"] for s in ref["steps"]], norms, rtol=RTOL)
    for step, (got, want) in enumerate(zip(ref["grads"], jax_run["grads"])):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * norms[step],
                                   err_msg=f"gradients of step {step}")


def test_one_process_validation_and_predictions_equal_the_jax_trainers(runs, jax_run):
    ref = runs[0][0]
    for key in ("val_token_acc", "val_molecular_accuracy"):
        assert ref["val"][key] == jax_run["val"][key], key
    np.testing.assert_allclose(ref["val"]["val_loss"], jax_run["val"]["val_loss"], rtol=RTOL)
    np.testing.assert_allclose(ref["avg_loss"], jax_run["avg_loss"], rtol=RTOL)
    assert ref["targets"] == jax_run["targets"]
    assert ref["predictions"] == jax_run["predictions"]


@pytest.mark.parametrize("world", WORLDS)
def test_steps_gradients_and_parameters_equal_the_one_process_run(runs, world):
    ref = runs[0][0]
    assert len(ref["steps"]) == 3 and ref["grads"].shape[0] == 3
    norms = np.linalg.norm(ref["grads"], axis=1)
    noise = (ref["grads"] != 0) & (np.abs(ref["grads"]) <= NOISE * norms[:, None])
    signal = ~noise.any(axis=0)
    assert signal.mean() > 0.99
    for rank in runs[world]:
        for key in ("loss", "model_only_loss", "alignment_loss", "grad_norm"):
            np.testing.assert_allclose([s[key] for s in rank["steps"]],
                                       [s[key] for s in ref["steps"]], rtol=RTOL, err_msg=key)
        for step, (got, want) in enumerate(zip(rank["grads"], ref["grads"])):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * norms[step],
                                       err_msg=f"gradients of step {step}")
        np.testing.assert_allclose(rank["params"][signal], ref["params"][signal], rtol=RTOL,
                                   atol=ATOL)
    if world == 1:
        for key in ("grads", "params"):
            np.testing.assert_array_equal(runs[1][0][key], ref[key])


@pytest.mark.parametrize("world", WORLDS)
def test_validation_metrics_are_the_same_on_every_rank_and_equal_one_process(runs, world):
    ref = runs[0][0]["val"]
    first = runs[world][0]["val"]
    for rank in runs[world]:
        assert rank["val"] == first
    assert first["val_token_acc"] == ref["val_token_acc"]
    assert first["val_molecular_accuracy"] == ref["val_molecular_accuracy"]
    for key in ("val_loss", "val_alignment_loss"):
        np.testing.assert_allclose(first[key], ref[key], rtol=RTOL, err_msg=key)
    for rank in runs[world]:
        np.testing.assert_allclose(rank["avg_loss"], runs[0][0]["avg_loss"], rtol=RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_ordered_predictions_equal_one_process(runs, world):
    ref = runs[0][0]
    assert _rank_ordered(runs[world], "targets", world) == ref["targets"]
    assert _rank_ordered(runs[world], "predictions", world) == ref["predictions"]


@pytest.mark.parametrize("world", (2, 4))
def test_unequal_token_counts_and_an_empty_rank_need_global_counts(runs, world):
    """Each batch's loss as the step computes it equals the one-process
    loss; a mean of per-rank means does not, on every batch here: the
    ranks' token counts differ, and the last batch's 1 row leaves the other
    ranks none."""
    ref = runs[0][0]["first_losses"]
    for rank in runs[world]:
        for got, want in zip(rank["first_losses"], ref):
            assert len(set(got["tokens"])) > 1
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
            assert not np.isclose(got["mean_of_means"], want["loss"], rtol=RTOL, atol=0)
    assert runs[world][0]["first_losses"][-1]["tokens"][1:] == [0] * (world - 1)


@pytest.mark.parametrize("world", WORLDS)
def test_only_rank_zero_writes_checkpoints(runs, world):
    ranks = runs[world]
    assert {"last", "best", "index.json"} <= set(ranks[0]["wrote_checkpoints"])
    for rank in ranks[1:]:
        assert rank["wrote_checkpoints"] == []


@pytest.mark.parametrize("world", WORLDS)
def test_async_saves_into_one_directory_write_from_rank_zero_alone(runs, world):
    """Both routes into a directory shared by the ranks: rank 0 alone
    writes, no collective runs off a main thread, and every rank returns
    the losses and reads the ``best`` and index of the synchronous route;
    the losses are the one-process run's (RTOL) and ``best`` is of its
    step."""
    ref = runs[0][0]["shared"]
    assert ref["async"]["pinned"] == ref["sync"]["pinned"] == [6]
    for r, rank in enumerate(runs[world]):
        assert rank["collectives_off_main_thread"] == []
        got, want = rank["shared"]["async"], rank["shared"]["sync"]
        assert got["losses"] == want["losses"]
        np.testing.assert_allclose(got["losses"], ref["async"]["losses"], rtol=RTOL)
        assert got["pinned"] == want["pinned"] == [6]
        assert got["index"] == want["index"] == runs[world][0]["shared"]["async"]["index"]
        assert got["best_step"] == want["best_step"] == ref["async"]["best_step"]
        np.testing.assert_array_equal(rank["best_async"], rank["best_sync"])
        np.testing.assert_array_equal(rank["best_async"], runs[world][0]["best_async"])
        for route in ("async", "sync"):
            assert (rank["shared"][route]["writes"] == []) == (r > 0)


@pytest.mark.parametrize("world", (0,) + WORLDS)
def test_a_failed_save_on_rank_zero_raises_on_every_rank(runs, world):
    """Rank 0's write error, from ``wait`` after ``save_async`` and from
    ``save``, is raised there; every other rank raises a RuntimeError
    after the same reduction (the run ended: no rank hung)."""
    for r, rank in enumerate(runs[world]):
        for route in ("async", "sync"):
            got = rank["failed_saves"][route]
            if r == 0:
                assert got == "OSError: no space left on device", (route, got)
            else:
                assert got.startswith("RuntimeError: A checkpoint save failed on rank 0"), (
                    route, got)


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_loss_and_beams_equal_across_world_sizes(runs, world):
    ref = runs[0][0]["dryrun"]
    for rank in runs[world]:
        np.testing.assert_allclose(rank["dryrun"]["loss"], ref["loss"], rtol=RTOL)
    base, rem = divmod(GLOBAL_BATCH, world)
    assert all(len(rank["dryrun"]["seqs"]) == base + (r < rem)
               for r, rank in enumerate(runs[world]))
    seqs = [row for rank in runs[world] for row in rank["dryrun"]["seqs"]]
    scores = [row for rank in runs[world] for row in rank["dryrun"]["scores"]]
    assert seqs == ref["seqs"]
    np.testing.assert_allclose(scores, ref["scores"], rtol=1e-5, atol=1e-6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_training_cli_across_two_processes(tmp_path):
    """The port's training CLI as torchrun starts it (``AFM_MULTIHOST=1``,
    ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``),
    on the CPU over gloo: rank 0 writes the checkpoints, each rank its
    ``_rank{r}`` predictions and metrics, and the ranks' predictions cover
    the test rows once."""
    test_data = REPO / "tests" / "test_data" / "ir_dataset"
    if not (test_data / "ir_data.parquet").exists():
        sys.path.insert(0, str(REPO / "tests"))
        from make_fixture import main

        main(test_data)
    args = [f"working_dir={tmp_path}", "job_name=train", "data=ir/patches",
            f"data_path={test_data}", "data.IR.preprocessor_arguments.patch_size=125",
            "data.Formula.column=molecular_formula", "model=custom_model", "trainer.epochs=1",
            "model.d_model=64", "model.encoder_layers=1", "model.decoder_layers=1",
            "model.encoder_ffn_dim=128", "model.decoder_ffn_dim=128",
            "model.encoder_attention_heads=4", "model.decoder_attention_heads=4",
            "model.batch_size=8", "model.n_beams=2", "model.dtype=float32", "+device=cpu"]
    port = _free_port()
    logs = [tmp_path / f"cli{r}.txt" for r in range(2)]
    procs = []
    for r in range(2):
        env = dict(_env(), AFM_MULTIHOST="1", RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs += _start([[sys.executable, "-m", "multimodalanalytical_tpu_torch.cli.training",
                          *args]], [logs[r]], env)
    _wait(procs, logs, "training CLI")
    run = tmp_path / "train"
    assert (run / "checkpoints" / "last").is_dir() and (run / "checkpoints" / "best").is_dir()
    assert not (run / "metrics_beam_2.json").exists()
    predictions = []
    for r in range(2):
        assert "Top-1" in json.loads((run / f"metrics_beam_2_rank{r}.json").read_text())
        predictions.append(json.loads(
            (run / f"test_data_logits_beam_2_rank{r}.json").read_text()))
    assert predictions[0]["avg_loss"] == predictions[1]["avg_loss"]
    targets = predictions[0]["targets"] + predictions[1]["targets"]
    assert len(targets) > 0 and all(len(p) == 2 for d in predictions
                                    for p in d["predictions"])
    assert "Joined a 2-process gloo group" in (run / "training.log").read_text()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(REPO))
    _worker(json.loads(sys.argv[2]))
