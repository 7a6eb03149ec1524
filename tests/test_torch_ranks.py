"""A card for each rank: the ranks of a `--gpu-nproc N` run map on
cuda:(rank % the CUDA devices PyTorch sees), as each JAX process maps on
its own local device.  Here (no card) PyTorch's device count and
availability are patched, and the rank's run stops where it would first
touch the card."""

import pytest
import torch

from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.utils import opts as O
from tests.conftest import golden_path


@pytest.mark.parametrize("rank,cards,want", [
    (0, 1, 0), (1, 1, 0), (1, 2, 1), (3, 4, 3), (5, 4, 1), (6, 8, 6)])
def test_a_rank_takes_its_card(rank, cards, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert cli.rank_device(torch.device("cuda"), rank) == \
        torch.device("cuda", want)


def test_a_cpu_run_or_a_named_card_stays(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cli.rank_device(torch.device("cpu"), 3) == torch.device("cpu")
    assert cli.rank_device(torch.device("cuda", 2), 3) == \
        torch.device("cuda", 2)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("rank", [0, 1, 2, 5])
def test_the_ranks_of_a_run_map_on_their_cards(rank, monkeypatch, tmp_path):
    """`_run` with --gpu-nproc 4 on a node of 3 cards: rank r's shard run
    gets cuda:(r % 3) and makes it the current card before its first
    launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    current = []

    def set_device(d):
        current.append(torch.device(d))
        raise _Stop
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    argv, args = cli.parse_args([
        "--gpu-chain", "--gpu-nproc", "4", "--gpu-rank", str(rank), "-o",
        str(tmp_path / "out"), golden_path("simref.fa.gz"),
        golden_path("simreads.fa.gz")])
    io_, mo = O.set_preset(args.preset)
    with pytest.raises(_Stop):
        cli._run(args, argv, io_, mo)
    assert current == [torch.device("cuda", rank % 3)]
