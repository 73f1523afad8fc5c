"""The reference imports nothing of JAX, of the JAX package or of the
program; the harness imports nothing of JAX or of the JAX package."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(folder):
    for d, dirs, files in os.walk(os.path.join(HERE, folder)):
        # benchmark/out/ is scratch space that git ignores (e.g. an
        # unpacked archive of the whole repository)
        dirs[:] = [x for x in dirs if x != "out"]
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(sources("reference")))
def test_reference_imports_nothing_of_the_program(path):
    bad = {"jax", "jaxlib", "flax", "julia_raytracer_tpu",
           "julia_raytracer_tpu_torch"}
    assert not set(top_level_imports(path)) & bad


def test_harness_imports_no_jax():
    bad = {"jax", "jaxlib", "flax", "julia_raytracer_tpu"}
    for path in sources("."):
        assert not set(top_level_imports(path)) & bad, path


def test_guard_compares_whole_top_level_names():
    from benchmark.run import forbidden_modules

    import julia_raytracer_tpu_torch  # noqa: F401  the port's name begins with the JAX package's

    assert "julia_raytracer_tpu" not in forbidden_modules()
