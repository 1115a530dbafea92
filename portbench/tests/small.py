"""The cells at a size a CPU test holds: every width of the cell's
configuration divided by 8 (the channels' ratios kept), 64 x 96 maps,
a few agents, and the cell's own limits."""

import json

from portbench import core

CELLS = ("ynet_sdd.serve_ttst", "ynetmod_ind.serve_ttst_cws",
         "ynet_sdd.finetune_mosa1", "ynetmod_ind.finetune_mosa1")


def bench():
    with open(core.CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def small(name):
    """-> (cell, configuration) of a cell at CPU size."""
    cell = core.read_json("workloads", name)
    cfg = core.read_json("configs", cell["config"])
    cfg = dict(cfg, encoder_channels=[c // 8 for c in cfg["encoder_channels"]],
               decoder_channels=[c // 8 for c in cfg["decoder_channels"]])
    cell = dict(cell, height=64, width=96, requests=40, agents=[1, 3],
                profile_requests=1, profile_steps=1)
    if cell["loop"] == "finetune":
        cell["batch_size"] = 4
    return cell, cfg
