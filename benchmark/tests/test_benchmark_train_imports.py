"""A training run's modules load no JAX, Flax or JAX package (whole
top-level names compared); the training reference loads nothing of the
program and turns TF32 off."""

from __future__ import annotations

import ast

from benchmark import harness
from benchmark.tests.test_benchmark_imports import PORT, _imported_names, _loaded_after


def test_a_whole_training_cell_loads_no_jax():
    code = "\n".join([
        "from benchmark import run, harness, train_formulas, train_trace, synth_train",
        "from benchmark.tools import train_readings",
        "import one_to_many_gan_torch.core.trainer, one_to_many_gan_torch.parallel",
        "cell = harness.cell('otm_prod512.train_dp4')",
        "harness.driver(cell['traffic_file']['driver'])",
        "harness.reference(cell['config_file']['reference'])",
        "[harness._load_module(harness.ROOT / 'metrics' / (m['name'] + '.py'), m['name'])"
        " for m in cell['per_layer']]",
    ])
    loaded = _loaded_after(code)
    assert PORT in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_training_reference_imports_nothing_of_the_program_and_sets_no_tf32():
    path = harness.ROOT / "reference" / "otm_train.py"
    assert not _imported_names(path) & {PORT, *harness.FORBIDDEN}
    loaded = _loaded_after("import benchmark.reference.otm_train")
    assert PORT not in loaded and not loaded & set(harness.FORBIDDEN)
    source = path.read_text()
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in source
    assert "torch.backends.cudnn.allow_tf32 = False" in source
    ast.parse(source)
