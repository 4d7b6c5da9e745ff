"""Multi-process PQL of the port (``pql_tpu_torch/parallel``) on the CPU, two
gloo ranks against one.

Each rank is a subprocess running this file as a script (``_worker``): a
free port for its ``tcp://`` rendezvous, a 60 s ``init_process_group``
timeout and a 300 s subprocess timeout, so a hung rendezvous fails in
seconds, not at the suite's limit.

- the sim stream (replay rows, obs, env steps) of 2 ranks, concatenated
  along the env axis, bitwise equal to 1 rank's (PQL and PQL-D, obs_norm
  off, lr 0: the JAX package's sharding-equivalence setting, at 16 actor
  rows per rank, see ``STREAM``); with obs_norm
  on, the all-reduced moments differ from the one-process sums by fp32
  reassociation only (held at the JAX test's rtol 1e-5 / atol 1e-6);
- the same obs stream as the JAX package's 2-device mesh run, from a
  converted JAX state with the JAX draws (tests/test_sharding_equivalence.py's
  tolerances);
- parameters, Adam moments, trackers and losses bitwise equal across the
  ranks after updates with lr > 0;
- ``update_sharded`` against the JAX one under ``shard_map`` on 2 devices;
- the refusals: num_envs and batch_size not divisible by the world,
  ``num_devices`` other than the world, ``dist.auto_tpu_pod``, and a world
  of 2 for an agent other than PQL (which still ignores ``num_devices``);
- a 2-rank kill-and-resume through ``train.main``: per-rank full-state
  files, resumed bitwise equal to an uninterrupted 2-rank run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(task="PointMass", num_envs=16, algo__batch_size=64, algo__memory_size=4096, algo__warm_up=4,
             algo__horizon_len=1, algo__iters_per_call=1)
STILL = dict(SMALL, algo__actor_lr=0.0, algo__critic_lr=0.0, algo__obs_norm=False)  # the sim stream alone
# 16 actor rows per rank: below 16 rows MKL's sgemm takes a small-M path that
# rounds a row's products differently from the same row in a taller batch
# (1 ulp; XLA's tiling does the same in tests/test_sharding_equivalence.py)
STREAM = dict(STILL, num_envs=32)
ITERS = 3
RMS_ROWS, RMS_DIM = 12, 3
INIT_TIMEOUT_S = 60
PROC_TIMEOUT_S = 300


def _launch(tmp_path, world: int, tag: str, **spec) -> list[dict]:
    """Run ``world`` worker ranks of ``spec`` (one process without a group
    for world 1); returns each rank's output."""
    port = free_port()
    procs, outs = [], []
    for rank in range(world):
        out = str(tmp_path / f"{tag}.rank{rank}.pt")
        s = dict(spec, world=world, rank=rank, port=port, out=out)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), json.dumps(s)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    try:
        logs = [p.communicate(timeout=PROC_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(logs)[-4000:]
    return [torch.load(o, weights_only=False) for o in outs]


def _cat(outs: list[dict], key: str, axis: int) -> torch.Tensor:
    return torch.cat([o[key] for o in outs], dim=axis)


# ------------------------------------------------------------------ worker


def _shard_conv(conv: dict, mesh, E: int) -> dict:
    """A converted global JAX PQL state cut to this rank by ``ENV_AXIS_FIELDS``."""
    from pql_tpu_torch.parallel import ENV_AXIS_FIELDS

    def cut(x, field):
        if isinstance(x, dict):
            return {k: cut(v, field) for k, v in x.items()}
        return mesh.shard(x, E, ENV_AXIS_FIELDS[field]) if torch.is_tensor(x) and x.dim() else x

    out = {k: cut(v, k) if k in ENV_AXIS_FIELDS else v for k, v in conv.items()}
    assert set(ENV_AXIS_FIELDS) <= set(conv)
    return out


def _worker(spec: dict) -> None:
    torch.set_num_threads(1)
    from pql_tpu_torch.algos.pql import PQL
    from pql_tpu_torch.cfg import make_config
    from pql_tpu_torch.ops.running_norm import RunningMeanStd
    from pql_tpu_torch.parallel import initialize, shutdown
    from pql_tpu_torch.utils.convert import load_pql_state

    world, rank = spec["world"], spec["rank"]
    dist_keys = {}
    if world > 1:
        dist_keys = dict(num_devices=world, dist__coordinator_address=f"localhost:{spec['port']}",
                         dist__num_processes=world, dist__process_id=rank)
    cfg = make_config(spec["algo"], **spec["size"], **dist_keys)
    assert initialize(cfg, "cpu", timeout_s=INIT_TIMEOUT_S) == (world > 1)
    out = {}
    if spec.get("refusals"):
        for name, bad in (("envs", dict(num_envs=cfg.num_envs - 1)), ("batch", dict(algo__batch_size=63)),
                          ("devices", dict(num_devices=world + 1))):
            try:
                PQL(make_config(spec["algo"], **{**spec["size"], **dist_keys, **bad}), device="cpu")
            except ValueError as e:
                out[f"refused_{name}"] = str(e)
    agent = PQL(cfg, device="cpu")
    state = agent.init()
    jax_run = torch.load(spec["jax"], weights_only=False) if spec.get("jax") else None
    if jax_run is not None:
        load_pql_state(state, _shard_conv(jax_run["state"], agent.mesh, cfg.num_envs))

    def draws(random: bool, i: int):
        d = agent.draw_iteration(state.gen, random)
        if jax_run is not None:  # the JAX sim draws, this rank's slice
            d.update({k: agent.mesh.shard(v, cfg.num_envs, 1) for k, v in jax_run["draws"][i].items()})
        return d

    state, _ = agent.warmup(state, draws(True, 0))
    losses = []
    for i in range(spec["iters"]):
        state, metrics = agent.train_iter(state, draws(False, i + 1))
        losses.append((metrics["train/critic_loss"], metrics["train/actor_loss"]))
    out.update(
        replay=state.replay.data, ptr=state.replay.ptr, obs=state.obs, env_steps=state.env_steps,
        rms={k: getattr(state.obs_rms, k) for k in ("mean", "var", "count")},
        actor=state.actor.state_dict(), critic=state.critic.state_dict(),
        critic_target=state.critic_target.state_dict(),
        moments=[(s["exp_avg"], s["exp_avg_sq"]) for opt in (state.actor_opt, state.critic_opt)
                 for s in opt.state.values()],
        trackers={n: (getattr(state, n).ring, getattr(state, n).count)
                  for n in ("return_tracker", "len_tracker", "success_tracker")},
        losses=torch.tensor(losses), counts=(state.critic_update_count, state.actor_update_count),
    )
    if spec.get("rms_rows"):
        x = torch.from_numpy(np.random.default_rng(9).normal(size=(RMS_ROWS, RMS_DIM)).astype(np.float32))
        rms = RunningMeanStd((RMS_DIM,), device="cpu")
        for part in (x, 2.0 * x + 1.0):
            rms.update_sharded(part.chunk(world)[rank])
        out["update_sharded"] = {k: getattr(rms, k) for k in ("mean", "var", "count")}
    torch.save(out, spec["out"])
    shutdown()


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("algo", ["pql", "pql_d"])
def test_sim_stream_two_ranks_equals_one(tmp_path, algo):
    """Replay rows, obs and counters of 2 ranks, joined on the env axis,
    bitwise equal to 1 rank's; the 2 ranks' refusals of sizes the world does
    not divide and of a num_devices other than the world."""
    one = _launch(tmp_path, 1, "one", algo=algo, size=STREAM, iters=ITERS)[0]
    two = _launch(tmp_path, 2, "two", algo=algo, size=STREAM, iters=ITERS, refusals=True)
    assert torch.equal(_cat(two, "replay", 1), one["replay"])
    assert torch.equal(_cat(two, "obs", 0), one["obs"])
    assert all(o["ptr"] == one["ptr"] and o["env_steps"] == one["env_steps"] for o in two)
    assert all(o["counts"] == one["counts"] == (8 * ITERS, 4 * ITERS) for o in two)
    for o in two:
        assert o["refused_envs"] == "num_envs=31 not divisible by mesh size 2"
        assert o["refused_batch"] == "batch_size=63 not divisible by mesh size 2"
        assert o["refused_devices"].startswith("num_devices=3 but the process group has 2 rank(s)")


def test_obs_norm_two_ranks_within_reassociation(tmp_path):
    """obs_norm on: the all-reduced moments and the stream they normalize
    agree with 1 rank's to fp32 reassociation (tests/test_sharding_equivalence.py's
    tolerances); ``update_sharded`` on 2 ranks matches the JAX one on a
    2-device mesh."""
    size = dict(STILL, algo__obs_norm=True)
    one = _launch(tmp_path, 1, "one", algo="pql", size=size, iters=ITERS)[0]
    two = _launch(tmp_path, 2, "two", algo="pql", size=size, iters=ITERS, rms_rows=True)
    for k in ("mean", "var", "count"):
        for o in two:
            assert torch.equal(o["rms"][k], two[0]["rms"][k])
        np.testing.assert_allclose(two[0]["rms"][k].numpy(), one["rms"][k].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_cat(two, "replay", 1).numpy(), one["replay"].numpy(), rtol=1e-4, atol=1e-5)

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pql_tpu.ops.running_norm import RunningMeanStd as JRMS
    from pql_tpu.parallel import make_mesh

    mesh = make_mesh(2)
    x = np.random.default_rng(9).normal(size=(RMS_ROWS, RMS_DIM)).astype(np.float32)

    def both(x):
        rms = JRMS.create((RMS_DIM,))
        rms = rms.update_sharded(x, "env").update_sharded(2.0 * x + 1.0, "env")
        return rms.mean, rms.var, rms.count

    want = jax.jit(jax.shard_map(both, mesh=mesh, in_specs=P("env"), out_specs=P(), check_vma=False))(jnp.asarray(x))
    for o in two:
        for k, w in zip(("mean", "var", "count"), want):
            np.testing.assert_allclose(o["update_sharded"][k].numpy(), np.asarray(w), rtol=1e-6, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("algo", ["pql", "pql_d"])
def test_params_bitwise_equal_across_ranks(tmp_path, algo):
    """lr 5e-4, obs_norm on: after the warm-up and three iterations every
    rank holds the same parameters, target, Adam moments, trackers and
    losses, bitwise, and the losses are finite."""
    two = _launch(tmp_path, 2, "two", algo=algo, size=SMALL, iters=ITERS)
    a, b = two
    assert not torch.equal(a["replay"], b["replay"])  # each rank its own envs
    for name in ("actor", "critic", "critic_target", "rms"):
        assert a[name].keys() == b[name].keys()
        assert all(torch.equal(a[name][k], b[name][k]) for k in a[name]), name
    assert all(torch.equal(x, y) for m, n in zip(a["moments"], b["moments"]) for x, y in zip(m, n))
    assert all(torch.equal(a["trackers"][n][0], b["trackers"][n][0]) for n in a["trackers"])
    assert torch.equal(a["losses"], b["losses"]) and bool(torch.isfinite(a["losses"]).all())


def _jax_global_draws(jagent, cfg, rng, random: bool) -> dict:
    """One call's sim draws over the global env axis, as
    ``_fused_step_local`` derives them from global env indices (warm-up:
    per-row uniform actions; else the mixed noise's per-row normals)."""
    import jax
    import jax.numpy as jnp

    from pql_tpu.ops.noise import per_row_normal, per_row_uniform
    from test_torch_rigid import jax_reset_draws

    E, A = cfg.num_envs, jagent.action_dim
    env = jagent.env_global
    _, k, _, _ = jax.random.split(rng, 4)
    acts, resets = [], []
    for _ in range(cfg.algo.warm_up if random else cfg.algo.horizon_len):
        k, k_a, k_n, k_e = jax.random.split(k, 4)
        acts.append(per_row_uniform(k_a, (E, A), jnp.float32, -1.0, 1.0, 0) if random
                    else per_row_normal(k_n, (E, A), jnp.float32, 0))
        _k_dyn, k_reset = jax.random.split(k_e)
        resets.append(jax_reset_draws(env.task, env.env_keys(k_reset, 0)))
    name = "action_uniform" if random else "explore_normal"
    return {name: torch.from_numpy(np.array(jnp.stack(acts))), "reset": torch.stack(resets)}


def test_obs_stream_matches_the_jax_two_device_mesh(tmp_path):
    """The JAX package's PQL on a 2-device mesh (warm-up and three
    iterations, lr 0, obs_norm off) and the port's 2 ranks from its
    converted initial state with its draws: the same replay rows and obs
    (tests/test_sharding_equivalence.py's rtol 1e-5 / atol 1e-6)."""
    import jax

    from pql_tpu.algos.pql import PQL as JPQL
    from pql_tpu.cfg import make_config as j_make_config
    from pql_tpu.parallel import make_mesh
    from pql_tpu_torch.utils.convert import pql_state_from_jax
    from test_torch_pql import _copy, _jax_tree

    jcfg = j_make_config("pql", **STILL)
    jagent = JPQL(jcfg, mesh=make_mesh(2))
    js = jagent.init(jax.random.PRNGKey(3))
    first = _copy(js)
    draws = [_jax_global_draws(jagent, jcfg, first.rng, True)]
    js, _ = jagent.warmup(js)
    for _ in range(ITERS):
        draws.append(_jax_global_draws(jagent, jcfg, np.array(js.rng), False))
        js, _ = jagent.train_iter(js)
    after = _copy(js)
    path = tmp_path / "jax_run.pt"
    torch.save(dict(state=pql_state_from_jax(_jax_tree(jagent, first), first.replay.layout), draws=draws), path)

    two = _launch(tmp_path, 2, "two", algo="pql", size=STILL, iters=ITERS, jax=str(path))
    replay = _cat(two, "replay", 1).numpy()
    for name, s, d in after.replay.layout:
        np.testing.assert_allclose(replay[..., s: s + d], after.replay.data[..., s: s + d], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(_cat(two, "obs", 0).numpy(), after.obs, rtol=1e-5, atol=1e-6)
    assert two[0]["env_steps"] == int(after.env_steps)


def test_refusals_without_a_group(tmp_path):
    """``dist.auto_tpu_pod`` is refused by name; ``train.main`` refuses a
    world of 2 for an agent other than PQL before it makes a group or a run
    directory; a one-process DDPG ignores ``num_devices`` as the JAX
    package's baselines do."""
    from pql_tpu_torch import train
    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import make_config
    from pql_tpu_torch.parallel import initialize, world_size

    with pytest.raises(ValueError, match="auto_tpu_pod=true is the JAX package's TPU-pod discovery"):
        initialize(make_config("pql", dist__auto_tpu_pod=True), "cpu")
    for algo in ("ddpg", "ddpgv", "ppo"):
        with pytest.raises(SystemExit, match=rf"runs in one process: only PQL splits its envs over ranks, and 2"):
            train.main([f"algo={algo}", "dist.num_processes=2", "dist.coordinator_address=localhost:1",
                        "dist.process_id=0", f"logging.out_dir={tmp_path}", "--device=cpu"])
    assert not os.listdir(tmp_path) and world_size() == 1
    agent = get_algo("DDPG")(make_config("ddpg", num_devices=2, num_envs=4, algo__batch_size=8,
                                         algo__memory_size=64), device="cpu")
    assert agent.num_envs == 4


def _entry(tmp_path, tag: str, world: int, max_step: int, ckpt: str):
    code = ("import sys, json; from pql_tpu_torch import train; a = json.loads(sys.argv[1]); "
            "import torch; torch.set_num_threads(1); train.main(a)")
    port = free_port()
    procs = []
    for rank in range(world):
        argv = ["algo=pql_d", "task=Cartpole", "num_envs=16", "algo.batch_size=64", "algo.memory_size=4096",
                "algo.warm_up=4", "algo.iters_per_call=2", "algo.eval_freq=4", "eval_num_envs=4",
                f"max_step={max_step}", f"checkpoint_dir={ckpt}", "checkpoint_freq=4",
                f"logging.out_dir={tmp_path / tag}", "logging.run_name=run", f"dist.num_processes={world}",
                f"dist.coordinator_address=localhost:{port}", f"dist.process_id={rank}", "--device=cpu"]
        procs.append(subprocess.Popen([sys.executable, "-c", code, json.dumps(argv)], text=True,
                                      env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=PROC_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(logs)[-4000:]
    return logs


def test_kill_and_resume_two_ranks_bitwise(tmp_path):
    """``train.main`` on 2 ranks: stopped after 8 iterations (a full-state
    file per rank at 4 and 8, evals on rank 0 alone), resumed to 16; an
    uninterrupted 2-rank run to 16; both ranks' files at 16 equal bitwise."""
    from pql_tpu_torch.utils.checkpoint import _load

    # total env steps are (4 warm-up steps + iterations) × 16 envs, checked after every 2 iterations
    stop, end = (4 + 7) * 16, (4 + 15) * 16  # the last checks that pass: iterations 6 and 14
    _entry(tmp_path, "a", 2, stop, str(tmp_path / "ck_resumed"))
    files = sorted(os.listdir(tmp_path / "ck_resumed" / "state"))
    assert files == ["state.rank0-of-2.pt", "state.rank1-of-2.pt"]
    logs = _entry(tmp_path, "b", 2, end, str(tmp_path / "ck_resumed"))
    assert "resumed the full state" in logs[0] and "resumed" not in logs[1]
    _entry(tmp_path, "c", 2, end, str(tmp_path / "ck_straight"))
    assert sorted(os.listdir(tmp_path / "a")) == ["run"]  # rank 0's run directory alone
    for r in range(2):
        got = _load(str(tmp_path / "ck_resumed" / "state"), f"state.rank{r}-of-2.pt")
        want = _load(str(tmp_path / "ck_straight" / "state"), f"state.rank{r}-of-2.pt")
        assert got["counters"] == want["counters"] and got["counters"]["env_steps"] == 4 + 16  # per env

        def leaves(x, prefix=""):
            if isinstance(x, dict):
                for k, v in x.items():
                    yield from leaves(v, f"{prefix}.{k}")
            elif torch.is_tensor(x):
                yield prefix, x

        g, w = dict(leaves(got)), dict(leaves(want))
        assert g.keys() == w.keys()
        assert [k for k in g if not torch.equal(g[k], w[k])] == []


if __name__ == "__main__":
    _worker(json.loads(sys.argv[1]))
