"""The control comes out as not correct: the reference put in the
program's place, computed in the precision below the configuration's
(the LM: fp8 products under bf16; the CNN: TF32 under float32 with TF32
off), and with half of each batch left out. At the cells' own sizes this
needs the card; on the CPU, at a reduced size, the LM's fp8 control still
reads far above the program's own gap."""
import math

import pytest
import torch

from portbench import harness


def _fails(cell, readings):
    return any(not math.isfinite(c["value"]) or c["value"] > cell["limits"][k]
               for k, c in readings.items())


def test_lm_control_reads_far_above_the_program(tiny):
    cell, cfg, driver = tiny("yi34b_l4_int8")
    out = driver.control_readings(cell, cfg, 11, torch.device("cpu"))
    run = harness.run_cell(cell, cfg, driver, 11, 0.2, False, torch.device("cpu"), 0.0,
                           harness.benchmark(), "yi34b_l4_int8")
    for k in ("loss_gap", "update_gap"):
        assert out["control"][k]["value"] > 100 * run["checks"][k]["value"], (out, run)
    assert _fails(cell, out["half_batch"]), out


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cnn_sweep8_int8", "yi34b_l4_int8"])
def test_control_and_half_batch_fail_at_the_cells_size(cuda_device, name):
    cell, cfg, driver = harness.cell_files(name)
    out = driver.control_readings(cell, cfg, 2**31 + 11, cuda_device)
    assert _fails(cell, out["control"]) and _fails(cell, out["half_batch"]), out
