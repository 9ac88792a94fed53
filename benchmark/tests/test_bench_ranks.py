"""The data-parallel training generator over four gloo processes on the
CPU at a tiny size: the steps follow the one-process reference over the
global batch, every rank holds the same parameters, and a run whose
gradients skip the exchange between ranks comes out not correct."""

import os
import traceback

import pytest
import torch.multiprocessing as mp

import benchmark.run as R
from benchmark.harness.ranks import free_port
from benchmark.harness.registry import Registry
from benchmark.tests.conftest import ROOT

WORLD = 4


def _rank(rank, port, config, traffic, fault, queue):
    try:
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        from benchmark.harness import ranks, train
        from benchmark.tests.conftest import cpu_context

        if fault:  # the gradients' all-reduce skipped: each rank keeps its own
            from var_tpu_torch.parallel import mesh as pm

            reduce = pm.all_reduce_
            pm.all_reduce_ = lambda t, group=None: t if t.numel() > 1000 else reduce(t, group)
        ctx = cpu_context(config, traffic)
        ranks.join(ctx, backend="gloo")
        out = train.run(ctx)
        ranks.leave(ctx)
        queue.put((rank, out["numbers"], out["e2e"]))
    except BaseException:
        queue.put((rank, traceback.format_exc(), None))


def run_ranks(config, traffic, fault=False):
    ctx = mp.get_context("spawn")
    queue, port = ctx.Queue(), free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, config, traffic, fault, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = dict((r, (n, e)) for r, n, e in (queue.get(timeout=600) for _ in procs))
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
    for r, (n, _) in got.items():
        assert isinstance(n, dict), n
    return got


@pytest.fixture
def dp_traffic(tiny_train_traffic):
    return dict(tiny_train_traffic, batch=2, pool=3)


def test_data_parallel_steps_follow_the_reference(tiny_config, dp_traffic):
    got = run_ranks(tiny_config, dp_traffic)
    numbers = got[0][0]
    assert numbers["rank_spread"] == 0.0
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert numbers[name] < 1e-4, (name, numbers[name])
    assert all(got[r][0] == {} for r in range(1, WORLD))
    assert R.judge(numbers, Registry(ROOT).limits("d16-train32-dp4"))[0]


def test_the_exchange_left_out(tiny_config, dp_traffic):
    numbers = run_ranks(tiny_config, dp_traffic, fault=True)[0][0]
    assert numbers["rank_spread"] > 0
    assert not R.judge(numbers, Registry(ROOT).limits("d16-train32-dp4"))[0]


RANK_SCRIPT = """
import os, sys, time
r = int(os.environ["RANK"])
assert os.environ["WORLD_SIZE"] == "4" and os.environ["MASTER_ADDR"] == "localhost"
if "fail" in sys.argv and r == 2:
    sys.exit(7)
if "fail" in sys.argv:
    time.sleep(60)  # the launcher stops a rank that outlives a failed one
print("noise")
print('{"rank": %d}' % r)
"""


def test_the_launcher_relays_rank_zero_and_stops_the_rest(tmp_path, capsys):
    from benchmark.harness.ranks import launch

    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    assert launch(str(script), [], 4, 0.0) == 0
    assert capsys.readouterr().out.splitlines()[-1] == '{"rank": 0}'
    assert launch(str(script), ["fail"], 4, 0.0) != 0
    assert capsys.readouterr().out == ""
