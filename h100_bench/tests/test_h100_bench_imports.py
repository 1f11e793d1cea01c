"""Nothing the benchmark loads has the top-level name of JAX, Flax or the
JAX package (compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(out.split())


def test_the_harness_loads_no_jax():
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
            "from core import runner, calibrate, faults\n"
            "from drivers import serve, train\n"
            "serve.port(); train.port()\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    names = _top_level(code)
    assert not names & {"jax", "jaxlib", "flax", "whisper_context_biasing_tpu"}
    assert "whisper_context_biasing_tpu_torch" in names


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\n"
            "from core import reference, traffic, weights, counts\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    names = _top_level(code)
    assert not names & {"jax", "jaxlib", "flax", "whisper_context_biasing_tpu",
                        "whisper_context_biasing_tpu_torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from core import runner

    monkeypatch.setitem(sys.modules, "whisper_context_biasing_tpu_torch_x", sys)
    assert runner.forbidden_modules() == [
        m for m in ("jax", "jaxlib", "flax", "whisper_context_biasing_tpu")
        if m in {k.split(".")[0] for k in sys.modules}]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in runner.forbidden_modules()
