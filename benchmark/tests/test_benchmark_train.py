"""The training cell on the CPU at a small size (32x32 images, two
downsamples, a global batch of 4 on two gloo ranks, float32): the port's
step is held to the plain reference leaf by leaf, the cell's run comes
out correct under its own limits, and each fault it can have, planted
under the timed path, comes out not correct. The harness's look for a
card is skipped: the cell runs through ``run.run_cell`` on the CPU.

The bfloat16 program and the control (the reference in float8) are held
to the limits on the cards, at the cell's own size
(``test_benchmark_train_card.py``): at this size a bfloat16 step's
rounding is not the cell's."""

from __future__ import annotations

import copy
import statistics
import time

import pytest
import torch

from benchmark import harness, synth
from benchmark.drivers import train_data_parallel as drv
from benchmark.reference import otm_train
from benchmark.run import result_line, run_cell

WORKLOAD = "otm_prod512.train_dp4"


def small_cell(ranks: int = 2) -> dict:
    cell = copy.deepcopy(harness.cell(WORKLOAD))
    config = cell["config_file"]["config"]
    config["data"]["image_size"] = [32, 32]
    config["architecture"]["min_latent_resolution"] = 8
    config["training"]["batch_size"] = 2 * ranks
    config["tpu"].update(data_parallel=ranks, native_loader=False, precision="float32")
    cell["traffic_file"].update(dataset_images=32)
    return cell


def _run(seed: int, fault=None, trace: bool = False) -> dict:
    return run_cell(small_cell(), seed=seed, seconds=1, trace=trace, device=torch.device("cpu"),
                    t_start=time.perf_counter(), fault=fault)


def test_program_is_correct_and_traced_line_has_the_cells_metrics():
    cell = small_cell()
    result = _run(2**31 + 11, trace=True)
    assert result["correct"], result["checks"]
    assert result["readings"]["ranks_max_abs_diff"] == 0.0
    assert result["readings"]["feed_rows_unmatched"] == 0
    assert result["attempted"] >= 32 and result["attempted"] % 16 == 0
    line = result_line(cell, result, True, {})
    names = set(line["metrics"])
    assert {"train_mfu", "train.data_wait_ms"} <= names
    # no device trace on the CPU: its readers find nothing and are left out, not 0
    assert not names & {"train.device_idle_pct", "train.d_phase_ms", "train.g_phase_ms",
                        "train.exchange_ms"}
    assert list(line)[-1] == "checks"
    assert 0 < line["metrics"]["train_mfu"]["value"] < 100


TERM_NUMBERS = {"r1": "r1_rel_err", "path": "path_rel_err"}


@pytest.mark.parametrize("fault", ["exchange", "half", "unchanged", "r1", "path", "p0", "feed"])
def test_faults_are_not_correct(fault):
    """Each fault reads not correct; R1 and the path term are compared on
    their own, so either left out reads 1 on its number, whatever the
    losses it is part of read."""
    result = _run(2**31 + 12, fault=fault)
    assert not result["correct"], (fault, result["checks"])
    if fault in TERM_NUMBERS:
        assert result["readings"][TERM_NUMBERS[fault]] == pytest.approx(1.0)


def test_a_rank_that_loads_the_jax_package_is_refused():
    """The ranks run the window: a JAX module that any of them has loaded
    once the window has closed refuses the run (exit code 4, no result),
    as ``run.py`` refuses its own process."""
    with pytest.raises(SystemExit) as refused:
        _run(2**31 + 15, fault="jax_loaded")
    assert refused.value.code == 4


def test_the_step_is_the_reference_leaf_by_leaf(tmp_path):
    """One process, no group: the port's ``make_train_step`` on step 0 (R1
    and path on, ADA at 0.25, EMA on) and two more steps, against the
    reference: each loss term within 1e-4 relative on step 0 (float32
    sums in another order; the program's plain warp sums in float64 with
    its own roundings of the tent weights), every leaf's first gradient within 1e-2 of
    its network's median leaf (bias gradients under instance norms are
    0 to rounding on both sides), and the reference in blocks of one row
    equal to it in one block within 1e-5 a loss and 1e-3 of the median
    leaf a gradient (the same sums split in another order)."""
    from one_to_many_gan_torch.augment.controller import init_ada_state
    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.core.state import Models, init_train_state
    from one_to_many_gan_torch.core.train_step import Batches, draw_step, make_train_step
    from one_to_many_gan_torch.core.trainer import seeded_generator

    cell = small_cell(1)
    config = load_config(harness.write_program_config(
        cell["config_file"]["config"], tmp_path / "c.toml"))
    models = Models(config, device="cpu")
    state = init_train_state(config, models)
    weights = drv.make_weights(config, 7, "cpu")
    for k, attr in drv.NETS.items():
        getattr(state, attr).load_state_dict(weights[k])
    state.ema_generator.load_state_dict(weights["g"])
    state.ada = init_ada_state("cpu", p=0.25)
    step = make_train_step(config, models)
    gen = torch.Generator().manual_seed(3)
    batches, draws, losses = [], [], []
    for i in range(2):
        bt = Batches(*(torch.rand(2, 32, 32, 1, generator=gen) * 2 - 1 for _ in range(4)))
        dr = draw_step(seeded_generator(5, i, "cpu"), config, models)
        batches.append(bt._asdict())
        draws.append(drv.tree(dr))
        state, metrics = step(state, bt, dr)
        losses.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            grads = {k: {n: float(state.__dict__[drv.OPTS[k]].state[p]["exp_avg"].norm() / 0.5)
                         for n, p in getattr(state, attr).named_parameters()}
                     for k, attr in drv.NETS.items()}
    whole = otm_train.run_steps(config, weights, batches, draws, ada_p=0.25, rows=2,
                                device="cpu")
    rows = otm_train.run_steps(config, weights, batches, draws, ada_p=0.25, rows=1,
                               device="cpu")
    for k in drv.TERMS:
        assert losses[0][k] == pytest.approx(whole.losses[0][k], rel=1e-4, abs=1e-6), k
        assert rows.losses[0][k] == pytest.approx(whole.losses[0][k], rel=1e-5, abs=1e-6), k
    for k, ref in whole.grads.items():
        med = statistics.median(ref.values())
        for n, v in ref.items():
            assert abs(grads[k][n] - v) <= 1e-2 * max(v, med), (k, n, grads[k][n], v)
            assert abs(rows.grads[k][n] - v) <= 1e-3 * max(v, med), (k, n)


def test_control_reads_above_the_reference(tmp_path):
    """The control (the reference in float8) departs from the float32
    reference on the same steps; not a limit, which is set on the cards."""
    cell = small_cell(1)
    from one_to_many_gan_torch.config import load_config

    config = load_config(harness.write_program_config(
        cell["config_file"]["config"], tmp_path / "c.toml"))
    weights = otm_train.init_weights(synth.normals(otm_train.shapes(config), 9, "cpu"))
    from benchmark import train_formulas

    gen = torch.Generator().manual_seed(1)
    batches = [{k: torch.rand(2, 32, 32, 1, generator=gen) * 2 - 1
                for k in ("d_shoeprints", "d_shoemarks", "g_shoeprints", "g_shoemarks")}]
    draws = [train_formulas.draws(config, gen)]
    ref = otm_train.run_steps(config, weights, batches, draws, ada_p=0.25, rows=2, device="cpu")
    ctl = otm_train.run_steps(config, weights, batches, draws, ada_p=0.25, rows=2, device="cpu",
                              precision="fp8")
    values = drv.compare(ctl, ref)
    assert values["loss_max_rel_err"] > 1e-3 and values["grad_norm_gap"] > 1e-2


def test_readings_tool_takes_each_fault_out_again(tmp_path):
    """One launch of the readings tool over faults, then the program: the
    faults read not correct, and the program after them reads correct
    (each fault's patches are taken out again), with its control; modes
    that fed the same rows and draws share the seed's reference run."""
    import json

    from benchmark.tools import train_readings

    cell = small_cell()
    out = tmp_path / "readings.jsonl"
    seed = 2**31 + 13
    spec = {"config_paths": {seed: str(drv.program_config_path(cell, tmp_path, seed))},
            "run_dir": str(tmp_path), "traffic": cell["traffic_file"], "trace": False,
            "check_steps": 3, "time_from": 10**9,
            "items": [("exchange", seed), ("r1", seed), ("path", seed), ("p0", seed),
                      ("program", seed)],
            "limits": cell["limits"]["limits"], "out": str(out), "control_seeds": [seed]}
    drv.spawn_ranks_only(train_readings.rank_main, cell, spec, torch.device("cpu"))
    rows = {r["mode"]: r for r in map(json.loads, out.read_text().splitlines())}
    assert set(rows) == {"exchange", "r1", "path", "p0", "program"}
    assert rows["program"]["correct"], rows["program"]["checks"]
    assert "control" in rows["program"]["readings"]
    for mode in ("exchange", "r1", "path", "p0"):
        assert not rows[mode]["correct"], (mode, rows[mode]["checks"])
    # r1, path and p0 fed the reference what exchange fed it: one run, handed on
    assert [rows[m]["readings"]["references_run"] for m in ("exchange", "r1", "path", "p0")] \
        == [1, 0, 0, 0]
    assert rows["program"]["readings"]["references_run"] == 1  # the control's
