"""What the harness and the reference load: never JAX, Flax or the JAX
package (whole top-level names compared), and, for the reference, nothing
of the program under test."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from benchmark import harness

PY_FILES = sorted(p for p in harness.ROOT.rglob("*.py") if "tests" not in p.parts)
PORT = "one_to_many_gan_torch"


def _loaded_after(code: str) -> set[str]:
    """Top-level names in ``sys.modules`` of a fresh interpreter after ``code``."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=harness.REPO, capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _imported_names(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_source_names_jax(path):
    assert not _imported_names(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in _imported_names(path)
    loaded = _loaded_after(f"import benchmark.reference.{path.stem}" if path.stem != "__init__"
                           else "import benchmark.reference")
    assert PORT not in loaded and not loaded & set(harness.FORBIDDEN)


def test_a_whole_cell_loads_no_jax():
    """Every module a serving run imports: the harness, the driver (with
    the program's server and engine), the readers and the clients."""
    code = "\n".join([
        "from benchmark import run, harness, clients, formulas, synth, trace",
        "from benchmark.tools import readings",
        "import one_to_many_gan_torch.serve, one_to_many_gan_torch.config",
        "cell = harness.cell('otm_default_bf16.serve_n64')",
        "harness.driver(cell['traffic_file']['driver'])",
        "harness.reference(cell['config_file']['reference'])",
        "[harness._load_module(harness.ROOT / 'metrics' / (m['name'] + '.py'), m['name'])"
        " for m in cell['per_layer']]",
    ])
    loaded = _loaded_after(code)
    assert PORT in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "one_to_many_gan_tpu_extra", sys)
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    found = harness.forbidden_modules()
    assert "flax" in found
    assert "jaxtyping_like" not in found and "one_to_many_gan_tpu_extra" not in found
