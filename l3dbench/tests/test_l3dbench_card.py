"""On the card: one short run of a cell as its command makes it, and the
TF32 control at the cell's own size on three seeds."""

import pytest

from l3dbench import compare, drive, program, reference_run, registry, run

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.gpu
def test_a_short_run_is_correct(card):
    res = run.run_cell(registry.cell("testdata26.unbundled"), SEEDS[0], 4.0,
                       False, card)
    assert res["correct"], res["checks"]
    assert res["metrics"]["images_per_s"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_at_the_cells_size(card, seed):
    cell = registry.cell("testdata26.unbundled")
    source = registry.generator(cell["config"]["generator"]).Source(
        cell["config"], cell["spec"], seed, card)
    inputs = source.scene(0)
    options = cell["spec"]["options"]
    pipe, _ = drive.scene(program.CLASSES, options, inputs, card)
    state = drive.outputs(pipe)["state"]
    del pipe
    ref_step, _ = reference_run.step(options, inputs, card)
    ref_lines = reference_run.recon(options, inputs, state, card)
    ctl = dict(step=reference_run.step(options, inputs, card, "tf32")[0],
               lines=reference_run.recon(options, inputs, state, card,
                                         "tf32"))
    ok, checks = compare.judge([compare.numbers(ctl, ref_step, ref_lines)],
                               cell["spec"]["limits"])
    assert not ok, checks
