"""The contact lab, ported (pql_tpu_torch.contact_lab), against the JAX lab
(scripts/contact_lab.py, imported unchanged) on the CPU.

- The cube scenes' trajectories: the port's ``run_cube`` and the JAX lab's
  over the first ``STEPS`` control steps (8 substeps each under
  ``box_ground_anchored_s``) with each scene's extra wrench: q within
  rtol 1e-5 / atol 1e-6 and qd within rtol 1e-5 / atol 1e-4 (the hand's
  substep tolerances, tests/test_torch_contact_hand.py; ten control steps
  of 8 substeps each add a few ulps per substep).
- The verdicts of ``cube_rest`` and ``cube_push`` equal the JAX lab's.
- The scenes, their order, ``KNOWN_REGRESSIONS`` and the exit rule are the
  JAX lab's; the Ant and hand scenes start from the JAX lab's initial
  states (``JAX_LAB_INIT`` equal, bit for bit, to the JAX tasks'
  ``init_state`` at the lab's keys).

The Ant and hand scenes run on the card only (chip_smoke.py phase 43):
eager on the CPU they take minutes.
"""

import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

import pql_tpu.envs.hand as jhand
import pql_tpu.envs.rigid as jrigid
from pql_tpu_torch import contact_lab as lab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10


def _jax_lab():
    spec = importlib.util.spec_from_file_location("jax_contact_lab", os.path.join(ROOT, "scripts", "contact_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jlab():
    return _jax_lab()


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wrenches(jnp_where, mg, half):
    """Each cube scene's extra wrench (the JAX lab's closures), by name;
    ``jnp_where`` is the package's ``where``."""
    F_push, F_slide, F_tip = 0.4 * mg, 1.8 * mg, 0.7 * mg
    tau = 3.0 * 1.2 * mg * half
    cos_commit = float(np.cos(np.radians(35.0)))

    def tip(t, p, R):
        F_t = jnp_where(R[2][2] < cos_commit, 0.0, F_tip)
        return [0.0, (p[2] + half) * F_t, -p[1] * F_t, F_t, 0.0, 0.0]

    return {
        "rest": (lambda t, p, R: [0.0] * 6, {}),
        "push_holds": (lambda t, p, R: [0.0, F_push * p[2], -F_push * p[1], F_push, 0.0, 0.0], {}),
        "push_slides": (lambda t, p, R: [0.0, F_slide * p[2], -F_slide * p[1], F_slide, 0.0, 0.0], {}),
        "twist": (lambda t, p, R: [0.0, 0.0, tau, 0.0, 0.0, 0.0], {}),
        "tip": (tip, {}),
        "settle_tilted": (lambda t, p, R: [0.0] * 6,
                          dict(z0=half + 0.002, quat0=[np.cos(0.015), np.sin(0.015), 0.0, 0.0])),
    }


@pytest.mark.parametrize("scene", ["rest", "push_holds", "push_slides", "twist", "tip", "settle_tilted"])
def test_run_cube_matches_the_jax_lab(jlab, scene):
    import jax.numpy as jnp

    m = lab.cube_only_model()
    mg = float(m.mass[0]) * 9.81
    wf_t, kw = _wrenches(torch.where, mg, lab.CUBE_HALF)[scene]
    wf_j, _ = _wrenches(jnp.where, mg, lab.CUBE_HALF)[scene]
    qs, qds, _ = lab.run_cube(m, wf_t, seconds=STEPS / 60.0, device="cpu", **kw)
    jqs, jqds = jlab.run_cube(jlab.cube_only_model(), wf_j, seconds=STEPS / 60.0, **kw)
    assert qs.shape == jqs.shape == (STEPS, m.nq) and qds.shape == jqds.shape == (STEPS, m.nv)
    np.testing.assert_allclose(qs, jqs, rtol=1e-5, atol=1e-6, err_msg="q")
    np.testing.assert_allclose(qds, jqds, rtol=1e-5, atol=1e-4, err_msg="qd")
    if scene == "push_slides":  # the cube has started to slide within the horizon
        assert qds[-1, 3] > 0.05


def _shape(line: str) -> str:
    return re.sub(r"-?\d+\.\d+", "#", line)


@pytest.mark.parametrize("scene", ["cube_rest", "cube_push"])
def test_verdicts_and_lines_match_the_jax_lab(jlab, scene, capsys):
    got = lab.SCENARIOS[scene]("cpu")
    port_lines = capsys.readouterr().out.splitlines()
    want = jlab.SCENARIOS[scene]()
    jax_lines = capsys.readouterr().out.splitlines()
    assert got.ok == want is True
    assert [_shape(x) for x in port_lines] == [_shape(x) for x in jax_lines]
    assert [x.split(":")[0] for x in port_lines] == [x.split(":")[0] for x in jax_lines]
    if scene == "cube_push":  # holds, holds, slides, as the JAX lab reads them
        assert [("holds" in x, "slides" in x) for x in port_lines[:3]] == [
            ("holds" in x, "slides" in x) for x in jax_lines[:3]]


def test_scenes_and_known_regressions_are_the_jax_labs(jlab):
    assert list(lab.SCENARIOS) == list(jlab.SCENARIOS)
    assert lab.KNOWN_REGRESSIONS == jlab.KNOWN_REGRESSIONS
    assert lab._TorqueHand.control_mode == jlab._TorqueHand.control_mode == "torque"


@pytest.mark.parametrize("task,key", [("Ant", 0), ("AllegroHand", 0), ("AllegroHand", 1)])
def test_initial_states_are_the_jax_labs(task, key):
    jt = jrigid.Ant() if task == "Ant" else jhand.AllegroHand()
    want = jt.init_state(jax.random.PRNGKey(key))
    pt = lab.Ant() if task == "Ant" else lab.AllegroHand()
    got = lab.initial_state(pt, task, key, "cpu")
    for k in ("q", "qd", "contact"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]), err_msg=k)


def test_exit_rule(monkeypatch, capsys):
    """A failing scene in KNOWN_REGRESSIONS is reported and does not gate;
    any other failing scene does (exit code 1, the JAX lab's FAILING line)."""
    result = lambda ok: (lambda device: lab.SceneResult(ok, {}))  # noqa: E731
    monkeypatch.setattr(lab, "SCENARIOS", {"cube_rest": result(True), "hand_goal": result(False)})
    assert lab.main(["--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert f"KNOWN-REGRESSION hand_goal: {lab.KNOWN_REGRESSIONS['hand_goal']}" in out
    assert out.rstrip().endswith("ALL PASS")
    monkeypatch.setattr(lab, "SCENARIOS", {"cube_rest": result(False), "hand_goal": result(False)})
    assert lab.main(["--device=cpu"]) == 1
    assert capsys.readouterr().out.rstrip().endswith("FAILING: cube_rest")
    assert lab.gate({"a": True, "b": False, "hand_goal": False}) == (["b"], ["hand_goal"])


def test_capture_guard_collects_first_and_pauses_gc():
    """``collected_gc`` (around every graph capture, the lab's included):
    the dead cycles are gone when the block starts, none is collected in it,
    and the collector's state comes back after it."""
    import gc
    import weakref

    from pql_tpu_torch.ops.graphs import collected_gc

    class Node:
        pass

    a = Node()
    a.self = a
    ref = weakref.ref(a)
    del a
    assert gc.isenabled()
    with collected_gc():
        assert ref() is None and not gc.isenabled()
    assert gc.isenabled()


def test_refusals():
    with pytest.raises(SystemExit, match="unknown scenario"):
        lab.main(["cube_nope", "--device=cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            lab.main(["cube_rest"])
