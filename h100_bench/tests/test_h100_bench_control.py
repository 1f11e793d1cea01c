"""The control of each cell comes out not correct: the reference one
precision below the configuration's (float8 operands), at the cell's own
size on the card, on three seeds; the program on the same seeds comes out
correct. A server cell judges the program's window and the control on the
same requests the Engine served, none of which may fail. A cell across
cards needs as many cards. (The port's own int8
decoder-weight path reads too close to the program on both served-token
numbers, the widest gap and the mean gap, for any limit to separate
them, so it is no control here.) Needs the card:

    python -m pytest h100_bench/tests/test_h100_bench_control.py -q -m cuda
"""

import json
import pathlib

import pytest
import torch

from core import calibrate, runner
from drivers import train_dp

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.loads(
    (pathlib.Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their published widths")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fails(readings: dict, limits: dict) -> bool:
    return any(v > limits[n] for n, v in readings.items())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(card, cell):
    spec = runner.load_spec(cell)
    if torch.cuda.device_count() < spec["workload"]["chips"]:
        pytest.skip(f"needs {spec['workload']['chips']} cards")
    limits = spec["cell"]["limits"]
    world = train_dp.start_world(spec, "cuda") if spec["traffic"]["kind"] == "train_dp" else None
    for seed in SEEDS:
        if spec["traffic"]["kind"] == "serve":
            prog, _ = calibrate.serve_readings(spec, seed, 2.0, "program")
            control, _ = calibrate.serve_readings(spec, seed, 2.0, "fp8")
        elif spec["traffic"]["kind"] == "server":
            got, checked = calibrate.server_readings(spec, seed, 10.0, control=True)
            assert checked["failed"] == 0, (seed, checked)
            prog, control = got["program"], got["fp8"]
        else:
            got, _ = calibrate.train_readings(spec, seed, control=True, world=world)
            prog, control = got["program"], got["fp8"]
        assert not _fails(prog, limits), (seed, prog)
        assert _fails(control, limits), (seed, control)
    if world is not None:
        world.close()
