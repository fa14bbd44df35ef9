"""Tensor parallelism in the port (``parallel/mesh.py``, ``parallel/tensor.py``,
the split Dense, attention, FFN and lm_head, the trainer's TP x DP step)
against the JAX package's GSPMD rules and its single-device step.

The file is also its own worker: ``python tests/test_torch_tensor_parallel.py
--worker '<json>'`` runs one rank of a gloo group on the CPU (a ``file://``
store in the test's directory, torch at one thread). One launch at world 2
runs layout (1, 2); one at world 4 runs (2, 2) and then (1, 4); each launch
has its own time limit (``communicate(timeout=...)``). On each layout the
worker runs ``parallel/dryrun.py``'s step and decode of the JAX dry run's
model (d_model 128, 2 + 2 layers, 8 heads, FFN 256, fp32, batch 8, dropout
0, no modality dropout) from the JAX package's initial weights, carried
across. The reference is the JAX ``Trainer``'s step and ``decode_fn`` on
one device with the same weights and batch: each layout's loss within 1e-5
and its gathered parameters within rtol 2e-4 / atol 2e-5
(``tests/test_multichip.py``'s bounds across meshes), its beams equal and
its scores within rtol 1e-4 / atol 1e-5 (``dryrun_multichip``'s).

At (1, 2) the worker also checks that sharding a state dict and gathering
it back is the identity, saves the trainer's state tree after a step (the
full tree, gathered) for a one-process restore, and runs every shipped
model config (cut to d_model 64, 4 heads, FFN 128, dropout 0) against one
process: its loss within 1e-5 and its beams equal, which covers T5's
sliced relative bias and the presets' lm_heads. At (2, 2) it records a
dropout draw on a replicated activation per rank.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more

REPO = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT_S = 240
LOSS_TOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-5
LAUNCHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
LAYOUTS = [layout for layouts in LAUNCHES.values() for layout in layouts]
SMALL = dict(d_model=64, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
             decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128)


# ------------------------------------------------------------------ worker
def _preset_batch():
    """The dry run's batch with a padded formula row and -100 labels."""
    from multimodalanalytical_tpu_torch.parallel.dryrun import dryrun_batch

    batch = dryrun_batch()
    batch["encoder_mask"][0, 8:12] = 0
    batch["encoder_inputs"]["Formula"][0, 8:] = 0
    batch["labels"][1, 20:] = -100
    return batch


def _presets_against_one_process(mesh, configs):
    """Each config's deterministic loss and K 2 beams, one process and on
    ``mesh``, from the same seeded weights."""
    from multimodalanalytical_tpu_torch.generation.beam_search import BeamDecoder
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel
    from multimodalanalytical_tpu_torch.models.weights import shard_state_dict
    from multimodalanalytical_tpu_torch.parallel.dryrun import DATA_CONFIG
    from multimodalanalytical_tpu_torch.training.trainer import device_batch

    batch = device_batch(_preset_batch(), torch.device("cpu"))
    out = {}
    for name, cfg in configs.items():
        one = Seq2SeqModel(cfg, DATA_CONFIG, "Smiles",
                           generator=torch.Generator().manual_seed(1))
        split = Seq2SeqModel(cfg, DATA_CONFIG, "Smiles",
                             generator=torch.Generator().manual_seed(2), mesh=mesh)
        split.load_state_dict(shard_state_dict(one.state_dict(), split))
        layer = split.decoder.layers[0]
        assert (layer.self_attn.num_heads, layer.ff.linear1.weight.shape[0]) == (
            cfg.decoder_attention_heads // 2, cfg.decoder_ffn_dim // 2)
        assert split.lm_head.weight.shape[0] == cfg.vocab_size // 2
        runs = []
        for model in (one, split):
            with torch.no_grad():
                loss = model(batch["encoder_inputs"], batch["encoder_mask"],
                             batch["decoder_ids"], batch["decoder_mask"],
                             batch["labels"])["loss"]
            seqs, scores = BeamDecoder(model).search(batch["encoder_inputs"],
                                                     batch["encoder_mask"], 2, max_length=8)
            runs.append({"loss": float(loss), "seqs": seqs.numpy(), "scores": scores.numpy()})
        out[name] = runs
    return out


def _worker(spec):
    import torch.distributed as dist

    from multimodalanalytical_tpu_torch.models.weights import (
        gather_state_dict,
        shard_state_dict,
    )
    from multimodalanalytical_tpu_torch.ops.dropout import dropout
    from multimodalanalytical_tpu_torch.parallel.dryrun import (
        dryrun_batch,
        dryrun_config,
        dryrun_model,
        run_layout,
    )
    from multimodalanalytical_tpu_torch.parallel.mesh import make_mesh
    from multimodalanalytical_tpu_torch.training.checkpoint import to_cpu
    from multimodalanalytical_tpu_torch.training.trainer import Trainer

    rank, world, workdir = spec["rank"], spec["world"], Path(spec["workdir"])
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}", rank=rank,
                            world_size=world)
    state = torch.load(spec["state"])
    config = dryrun_config(dropout=0.0)
    results = {}
    for n_data, n_model in LAUNCHES[world]:
        mesh = make_mesh(n_data, n_model)
        model = dryrun_model(mesh, config=config)
        result = run_layout(mesh, state=state, modality_dropout=(), model=model)
        results[(n_data, n_model)] = {
            "loss": result.loss, "seqs": result.seqs, "scores": result.scores,
            "params": result.params if rank == 0 else None,
            "local_heads": model.encoder.layer_0.self_attn.num_heads}
        if (n_data, n_model) == (1, 2):
            model = dryrun_model(mesh, config=config)
            model.load_state_dict(shard_state_dict(state, model))
            gathered = gather_state_dict(model)
            results["shard_gather_identity"] = all(
                torch.equal(gathered[k], torch.as_tensor(v)) for k, v in state.items())
            trainer = Trainer(model, num_steps=4, lr=1e-3, seed=0)
            trainer.train_step(dict(dryrun_batch(), n_valid=8))
            tree = to_cpu(trainer.state_tree())
            if rank == 0:
                torch.save(tree, workdir / "tp_tree.pt")
            again = Trainer(dryrun_model(mesh, config=config), num_steps=4, lr=1e-3, seed=0)
            again.load_state_tree(tree)
            back = to_cpu(again.state_tree())
            results["tp_restore_identity"] = (
                all(torch.equal(back["params"][k], v) for k, v in tree["params"].items())
                and all(torch.equal(a, b) for key in ("mu", "nu")
                        for a, b in zip(back["opt_state"][key], tree["opt_state"][key])))
            with open(spec["presets"], "rb") as f:
                results["presets"] = _presets_against_one_process(mesh, pickle.load(f))
        if (n_data, n_model) == (2, 2):
            trainer = Trainer(dryrun_model(mesh, config=config), seed=0)
            trainer._seed_step()
            draw = dropout(torch.ones(256), 0.5, trainer.dropout_generator)
            results["dropout_draw"] = (mesh.data_index, mesh.model_index, draw.numpy())
    with open(workdir / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


# ------------------------------------------------------------------- tests
# The JAX package is imported by the tests only, never by a worker.
def _jax_dryrun_model(d_model=128, layers=2, ffn=256, vocab=64):
    """``__graft_entry__._flagship`` of the dry run, with dropout 0."""
    from multimodalanalytical_tpu.models import ModelConfig, Seq2SeqModel

    from multimodalanalytical_tpu_torch.parallel.dryrun import DATA_CONFIG

    cfg = ModelConfig(d_model=d_model, encoder_layers=layers, decoder_layers=layers,
                      encoder_attention_heads=8, decoder_attention_heads=8,
                      encoder_ffn_dim=ffn, decoder_ffn_dim=ffn, vocab_size=vocab,
                      dtype="float32", dropout=0.0)
    return Seq2SeqModel(config=cfg, data_config=DATA_CONFIG, target_modality="Smiles")


class _Tok:
    def batch_decode(self, ids, skip_special_tokens=True):
        return ["C"] * len(ids)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX Trainer's step and decode on one device (the dry run's
    ``_run_mesh_shape`` at mesh (1, 1), modality dropout off): initial and
    stepped params (port names), loss, beams and scores."""
    jax = pytest.importorskip("jax")
    from multimodalanalytical_tpu.parallel.mesh import make_mesh
    from multimodalanalytical_tpu.training.trainer import (
        Trainer,
        _device_batch,
        _modality_segments,
    )
    from multimodalanalytical_tpu_torch.models.weights import flax_to_state_dict
    from multimodalanalytical_tpu_torch.parallel.dryrun import BEAMS, MAX_LENGTH, dryrun_batch

    model = _jax_dryrun_model()
    batch = dict(dryrun_batch(), n_valid=8)
    mesh = make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    trainer = Trainer(model, _Tok(), num_steps=4, lr=1e-3, mesh=mesh, seed=0)
    state = trainer.init_state(batch)
    initial = flax_to_state_dict(jax.device_get(state.params))
    device_batch = _device_batch(batch)
    step = trainer._build_train_step(_modality_segments(device_batch["encoder_inputs"]))
    state, metrics = step(state, device_batch)
    seqs, scores = trainer.decode_fn(num_beams=BEAMS, max_length=MAX_LENGTH)(
        state.params, device_batch["encoder_inputs"], device_batch["encoder_mask"])
    return {"initial": initial, "params": flax_to_state_dict(jax.device_get(state.params)),
            "loss": float(metrics["loss"]), "seqs": np.asarray(seqs),
            "scores": np.asarray(scores, np.float32)}


def _shipped_configs():
    """Every shipped model config, resolved by the port, cut to SMALL with
    dropout 0 (vocabulary 64: splits in two)."""
    yaml = pytest.importorskip("yaml")
    from multimodalanalytical_tpu_torch.models import config as port_config

    configs = {}
    for path in sorted((REPO / "configs" / "model").glob("*.yaml")):
        model_config = dict(yaml.safe_load(path.read_text()), **SMALL, dtype="float32",
                            max_target_length=16)
        cfg = port_config.resolve_model_config(model_config, vocab_size=64, pad_token_id=0,
                                               bos_token_id=2, eos_token_id=3)
        configs[path.stem] = dataclasses.replace(cfg, dropout=0.0)
    return configs


@pytest.fixture(scope="module")
def tp_runs(jax_reference, tmp_path_factory):
    """{world: [per-rank results]} of the world-2 and world-4 launches,
    started together, each waited on within its own time limit."""
    root = tmp_path_factory.mktemp("tp")
    state_path = root / "initial.pt"
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in jax_reference["initial"].items()},
               state_path)
    presets_path = root / "presets.pkl"
    with open(presets_path, "wb") as f:
        pickle.dump(_shipped_configs(), f)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    launches = {}
    for world in LAUNCHES:
        workdir = root / f"world{world}"
        workdir.mkdir()
        procs = []
        for rank in range(world):
            spec = {"rank": rank, "world": world, "workdir": str(workdir),
                    "store": str(workdir / "store"), "state": str(state_path),
                    "presets": str(presets_path)}
            with open(workdir / f"log{rank}.txt", "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--worker", json.dumps(spec)], cwd=REPO,
                    env=env, stdout=out, stderr=subprocess.STDOUT))
        launches[world] = (workdir, procs)
    runs = {}
    try:
        for world, (workdir, procs) in launches.items():
            for proc in procs:
                proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    finally:
        for _, procs in launches.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    for world, (workdir, procs) in launches.items():
        for rank, proc in enumerate(procs):
            log = (workdir / f"log{rank}.txt").read_text()[-4000:]
            assert proc.returncode == 0, f"world {world} rank {rank} failed:\n{log}"
        runs[world] = []
        for rank in range(world):
            with open(workdir / f"rank{rank}.pkl", "rb") as f:
                runs[world].append(pickle.load(f))
        runs[world][0]["workdir"] = workdir
    return runs


def _axis(spec):
    """JAX PartitionSpec of a flax leaf -> the sharded axis of the port's
    (out, in) tensor: a kernel's (in, out) axes swap, a bias keeps its own."""
    names = [i for i, name in enumerate(spec) if name is not None]
    return names[0] if names else None


@pytest.mark.parametrize("n_model", [2, 4])
def test_param_shardings_match_jax(jax_reference, n_model):
    """The port's rules against ``param_shardings`` of the JAX package on
    the dry run's flax tree (8 virtual CPU devices, meshes (4, 2) and
    (2, 4)): the same leaves split, along the same axis transposed. The
    stated difference: the port slices ``qkv_proj`` / ``kv_proj`` per head
    (3 and 2 blocks), JAX in contiguous chunks of the fused axis."""
    jax = pytest.importorskip("jax")
    from multimodalanalytical_tpu.parallel.mesh import make_mesh, param_shardings
    from multimodalanalytical_tpu.training.trainer import Trainer
    from multimodalanalytical_tpu_torch.parallel import mesh as port_mesh
    from multimodalanalytical_tpu_torch.parallel.dryrun import (
        dryrun_batch,
        dryrun_config,
        dryrun_model,
    )

    model = _jax_dryrun_model()
    params = Trainer(model, _Tok(), num_steps=4, seed=0).init_state(
        dict(dryrun_batch(), n_valid=8)).params
    jax_mesh = make_mesh(n_data=8 // n_model, n_model=n_model, devices=jax.devices()[:8])
    flat = jax.tree_util.tree_flatten_with_path(param_shardings(params, jax_mesh))[0]
    want = {}
    for path, sharding in flat:
        keys = [str(p.key) for p in path]
        name = ".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight",
                                      "embedding": "weight"}.get(keys[-1], keys[-1])])
        axis = _axis(sharding.spec)
        want[name] = None if axis is None else (1 - axis if keys[-1] == "kernel" else axis)
    specs = port_mesh.param_shardings(dryrun_model(config=dryrun_config(dropout=0.0)),
                                      port_mesh.Mesh(8 // n_model, n_model))
    assert set(specs) == set(want)
    got = {name: None if spec is None else spec.axis for name, spec in specs.items()}
    assert got == want
    assert sum(spec is not None for spec in specs.values()) == sum(
        axis is not None for axis in want.values()) > 0
    fused = {name: spec.blocks for name, spec in specs.items()
             if spec is not None and spec.blocks > 1}
    assert fused and all(blocks == (3 if ".qkv_proj." in name else 2)
                         for name, blocks in fused.items())


@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"{d}x{m}" for d, m in LAYOUTS])
def test_layout_step_and_decode_match_jax(tp_runs, jax_reference, layout):
    """Every rank of the layout reports the JAX step's loss (1e-5) and
    beams (equal, scores within rtol 1e-4 / atol 1e-5); rank 0's gathered
    parameters after the step are the JAX step's within rtol 2e-4 / atol
    2e-5. The layout splits the heads as it should."""
    ranks = tp_runs[layout[0] * layout[1]]
    for rank in ranks:
        got = rank[layout]
        assert got["local_heads"] == 8 // layout[1]
        assert abs(got["loss"] - jax_reference["loss"]) < LOSS_TOL, (got["loss"],
                                                                      jax_reference["loss"])
        np.testing.assert_array_equal(got["seqs"], jax_reference["seqs"])
        np.testing.assert_allclose(got["scores"], jax_reference["scores"], rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)
    params = ranks[0][layout]["params"]
    assert set(params) == set(jax_reference["params"])
    for name, want in jax_reference["params"].items():
        np.testing.assert_allclose(params[name].numpy(), np.asarray(want), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)


def test_shard_then_gather_is_the_identity(tp_runs):
    assert all(rank["shard_gather_identity"] for rank in tp_runs[2])


def test_a_tp_checkpoint_restores_into_one_process_bit_for_bit(tp_runs):
    """The state tree saved at (1, 2) after a step holds the full tensors:
    a one-process trainer restores it bit for bit (parameters and Adam
    moments), and a (1, 2) trainer restores it and gathers the same bits."""
    from multimodalanalytical_tpu_torch.parallel.dryrun import dryrun_config, dryrun_model
    from multimodalanalytical_tpu_torch.training.trainer import Trainer

    assert all(rank["tp_restore_identity"] for rank in tp_runs[2])
    tree = torch.load(tp_runs[2][0]["workdir"] / "tp_tree.pt")
    trainer = Trainer(dryrun_model(config=dryrun_config(dropout=0.0)), num_steps=4, lr=1e-3)
    trainer.load_state_tree(tree)
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(value, tree["params"][name]), name
    for key in ("mu", "nu"):
        for got, want in zip(trainer.optimizer.state_dict()[key], tree["opt_state"][key]):
            assert torch.equal(got, want)
    assert trainer.global_step == 1 and any(m.abs().max() > 0 for m in tree["opt_state"]["mu"])


def test_dropout_draw_is_shared_by_a_model_group_and_not_by_data_ranks(tp_runs):
    draws = {rank["dropout_draw"][:2]: rank["dropout_draw"][2] for rank in tp_runs[4]}
    assert np.array_equal(draws[(0, 0)], draws[(0, 1)])
    assert np.array_equal(draws[(1, 0)], draws[(1, 1)])
    assert not np.array_equal(draws[(0, 0)], draws[(1, 0)])


@pytest.mark.parametrize("name", sorted(p.stem for p in (REPO / "configs" / "model")
                                        .glob("*.yaml")))
def test_every_shipped_model_config_at_one_by_two(tp_runs, name):
    """(1, 2) against one process on the same weights, dropout 0: the loss
    within 1e-5, the beams equal, the scores within rtol 1e-4 / atol 1e-5."""
    for rank in tp_runs[2]:
        one, split = rank["presets"][name]
        assert abs(one["loss"] - split["loss"]) < LOSS_TOL, (one["loss"], split["loss"])
        np.testing.assert_array_equal(one["seqs"], split["seqs"])
        np.testing.assert_allclose(one["scores"], split["scores"], rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(REPO))
    _worker(json.loads(sys.argv[2]))
