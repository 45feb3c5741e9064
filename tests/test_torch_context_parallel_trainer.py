"""Context parallelism in the trainer and the CLI, over two gloo ranks
(`test_torch_ring_attention.spawn_ranks`):

- `GRPOTrainer(mesh=make_mesh(), context_parallel_size=2)` in both layouts
  (the zig-zag one under remat), its parameters sharded over the two ranks
  (FSDP, compared through `gathered_params`): the first rank rolls out and
  broadcasts the
  scored groups, both ranks train the same full-row batch padded to the
  layout's multiple, the reference log-probs come from the ring forward;
  two `step_batch` calls (one optimizer update at accumulation 2) against
  the port's one-process full-row trainer (`shared_prefix_loss=False`, which
  tests/test_torch_full_row.py holds against JAX): each step's loss, the
  gathered metrics and the updated weights (2e-5 relative for the loss, 2e-4
  for the metrics, 2e-6 absolute for the weights: f32 sums in another order,
  as tests/test_torch_trainer.py), the ranks' weights bit-equal;
- `cli.train.main` with `--context_parallel_size 2` under two ranks, from an
  HF checkpoint on a clip decoded by the port's decoder: both ranks train to
  the same weights, full rows, and rank 0 alone writes the checkpoints, whose
  final one reloads equal to them.

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_multiprocess_dp import EXAMPLES, _leaf_list, _trainer
from test_torch_ring_attention import spawn_ranks

LAYOUTS = [("zigzag", True), ("contiguous", False)]  # (layout, gradient_checkpointing)


def _steps(tr):
    infos = [tr.step_batch([EXAMPLES[0]]) for _ in range(2)]
    return dict(losses=[i["loss"] for i in infos], metrics=tr.pop_metrics(), params=_leaf_list(tr.gathered_params()))


def _worker(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import make_mesh, maybe_init_distributed

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    mesh = make_mesh()
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    out = {}
    for layout, remat in LAYOUTS:
        tr = _trainer(payload["params"][layout], payload["ref_params"], cfg, os.path.join(workdir, layout),
                      mesh=mesh, context_parallel_size=2, context_parallel_layout=layout,
                      gradient_accumulation_steps=2, gradient_checkpointing=remat)
        assert not tr.c.shared_prefix_loss and tr._cp.layout == layout
        out[layout] = _steps(tr)

    from time_r1_tpu_torch.cli import train as cli
    from tiny_tokenizer import TinyTokenizer

    processor = cli.Qwen25VLProcessor(TinyTokenizer(), pad_token_id=cfg.pad_token_id, eos_token_id=cfg.eos_token_id)
    cli.Qwen25VLProcessor.from_pretrained = classmethod(lambda cls, path, **kw: processor)
    tr = cli.main(cli.get_args(payload["cli_argv"]), device="cpu")
    out["cli"] = dict(params=_leaf_list(tr.gathered_params()), steps=tr.global_step, cp=tr._cp.size,
                      full_rows=not tr.c.shared_prefix_loss)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax

    from test_torch_bridge import VOCAB, jax_params, port_params
    from test_torch_train_cli import _annotations, _hf_checkpoint
    from test_torch_video import write_clip

    jp = jax_params()
    jref = {**jp, "text": jax.tree.map(lambda x: x * 0.9, jp["text"])}
    workdir = tmp_path_factory.mktemp("cp_trainer")
    clips = [write_clip(workdir / "a.mp4", seed=0), write_clip(workdir / "b.mp4", seed=1)]
    data = _annotations(workdir, clips)
    hf = _hf_checkpoint(workdir / "hf")
    argv = ["--model_name_or_path", hf, "--output_dir", str(workdir / "cli_out"), "--train_data_path", data,
            "--reward_funcs", "iou", "format", "--num_generations", "2", "--max_completion_length", "4",
            "--num_train_epochs", "1", "--learning_rate", "1e-3", "--save_steps", "1", "--report_to", "none",
            "--total_pixels", str(8 * 28 * 28), "--video_min_pixels", str(4 * 28 * 28),
            "--context_parallel_size", "2"]
    torch.save(dict(vocab=VOCAB, params={lay: port_params(jp) for lay, _ in LAYOUTS}, ref_params=port_params(jref),
                    cli_argv=argv), os.path.join(workdir, "payload.pt"))
    return jp, jref, workdir, spawn_ranks("test_torch_context_parallel_trainer", "_worker", 2, workdir)


@pytest.mark.parametrize("layout,remat", LAYOUTS, ids=[lay for lay, _ in LAYOUTS])
def test_cp_trainer_matches_one_process_full_rows(setup, tmp_path, layout, remat):
    from test_torch_bridge import CFG, port_params

    jp, jref, _, results = setup
    r0, r1 = (r[layout] for r in results)
    assert r0["losses"] == r1["losses"] and r0["metrics"] == r1["metrics"]
    for a, b in zip(r0["params"], r1["params"]):
        assert torch.equal(a, b)
    one = _trainer(port_params(jp), port_params(jref), CFG, str(tmp_path), shared_prefix_loss=False,
                   gradient_accumulation_steps=2, gradient_checkpointing=remat)
    want = _steps(one)
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=2e-5, atol=2e-6)
    assert set(r0["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert r0["metrics"][k] == pytest.approx(v, rel=2e-4, abs=2e-5), k
    for a, b in zip(r0["params"], want["params"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)
    assert max(float((a - b).abs().max()) for a, b in zip(r0["params"], _leaf_list(port_params(jp)))) > 0


def test_cli_trains_with_context_parallelism(setup):
    from time_r1_tpu_torch.models.qwen25vl import convert as conv

    _, _, workdir, results = setup
    c0, c1 = results[0]["cli"], results[1]["cli"]
    assert c0["cp"] == c1["cp"] == 2 and c0["full_rows"] and c0["steps"] == c1["steps"] == 3
    for a, b in zip(c0["params"], c1["params"]):
        assert torch.equal(a, b)
    out = workdir / "cli_out"
    assert json.loads((out / "trainer_state.json").read_text()) == {"global_step": 3}
    assert (out / "epoch-1").is_dir() and (out / "checkpoint-1").is_dir()
    saved, _ = conv.load_checkpoint(str(out), device="cpu")
    from time_r1_tpu_torch.rl.grpo import _leaves

    for a, b in zip(_leaves(saved), c0["params"]):
        assert torch.equal(a, b)
