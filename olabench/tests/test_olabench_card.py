"""The harness on the card: the table made again from the seed is the same
bytes, the reference parses them on the card as on the CPU, and a short
run of each cell at a small size comes out correct through the CUDA
kernels.  Marked ``cuda``: they skip without a card."""

import time

import pytest
import torch

from harness import cell as cell_run
from harness import spec, table
from reference import exact_aggregates as ref

pytestmark = pytest.mark.cuda


def test_table_is_the_same_bytes_each_time(card):
    t = dict(spec.cell(spec.load(), "zipf16-packed.adhoc").config["table"],
             num_tuples=4 * 65536, num_chunks=4)
    a = [table.digest(r) for r in table.chunks(dict(t, seed=2 ** 31 + 9), card)]
    b = [table.digest(r) for r in table.chunks(dict(t, seed=2 ** 31 + 9), card)]
    assert a == b


def test_reference_parses_alike_on_card_and_cpu(card):
    t = dict(spec.cell(spec.load(), "zipf16-packed.adhoc").config["table"],
             num_tuples=65536, num_chunks=1)
    raw = next(table.chunks(dict(t, seed=4), card))
    on_card = ref.parse_fixed_ascii(raw, 16).cpu()
    on_cpu = ref.parse_fixed_ascii(raw.cpu(), 16)
    assert torch.equal(on_card, on_cpu)


@pytest.mark.parametrize("config", ["zipf16-packed", "zipf16-files"])
def test_short_run_on_the_card_is_correct(card, config):
    cell = spec.cell(spec.load(), "zipf16-packed.adhoc")
    cell.config = spec.read_config(config)
    cell.config["table"].update(num_tuples=64 * 8192, num_chunks=64)
    res = cell_run.run(cell, 5, 3.0, True, card, time.perf_counter())
    assert res["verdict"]["correct"], res["verdict"]
    prof = res["record"]["profile"]
    assert prof["busy_s"] > 0 and prof["rounds"] > 0
