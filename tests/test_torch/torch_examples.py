"""Loading and running the example scripts of both packages side by side.

``examples/`` (the JAX package's) and ``examples_torch/`` (the port's)
hold scripts of the same names, and ``tests/test_examples`` imports the
JAX ones by bare name from ``sys.path``.  So each script is loaded by path
under a module name of its own (``examples_<name>``,
``examples_torch_<name>``; ``chip_smoke.load_example``): neither can come
back from the other's ``sys.modules`` entry.
"""

import ast
import json
import pathlib

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[2]
DIRS = {"jax": ROOT / "examples", "torch": ROOT / "examples_torch"}
TORCH_DIR = DIRS["torch"]
SCRIPTS = ("convex_collimator", "chromatic_dispersion", "reflective_beam_expander",
           "lens_design", "microlens_array")
FORBIDDEN = ("jax", "optax", "flax", "pyrayt_tpu")


def load(package, name):
    """The example ``name`` of ``package`` ("jax" or "torch")."""
    return chip_smoke.load_example(name, str(DIRS[package]))


def run(fn, *args, **kwargs):
    """``(fn's return value, the lines it printed)``."""
    return chip_smoke.captured(lambda: fn(*args, **kwargs))


def run_notebook(package, replacements=()):
    """The printed lines of ``lens_design.ipynb``'s code cells, each ``(old,
    new)`` of ``replacements`` made, and its namespace after the last cell
    (matplotlib on Agg, figures closed)."""
    namespace, lines = run(chip_smoke.run_notebook, replacements, str(DIRS[package]))
    return lines, namespace


def line_faults(lines, expected):
    """The printed lines that differ from the JAX script's: equal text,
    numbers printed at full precision (the last bits of a sum taken in
    another order) within 1e-12 relative (``chip_smoke.line_faults``)."""
    return chip_smoke.line_faults(lines, expected, rtol=1e-12)


def imported_roots(path):
    """The top-level package of every import in a script or in the code
    cells of a notebook."""
    path = pathlib.Path(path)
    if path.suffix == ".ipynb":
        cells = json.loads(path.read_text())["cells"]
        source = "\n".join("".join(c["source"]) for c in cells if c["cell_type"] == "code")
    else:
        source = path.read_text()
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots
