"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a tiny size, judged by the cells' own limits. One test a fault the cell
can have."""

import pytest
import torch

import benchmark.run as R
from benchmark.harness import sample, train
from benchmark.harness.registry import Registry
from benchmark.tests.conftest import ROOT, cpu_context


def judged(cell: str, numbers: dict) -> bool:
    return R.judge(numbers, Registry(ROOT).limits(cell))[0]


@pytest.mark.parametrize("cell", ["d16-fid50", "d30-demo8"])
def test_a_sound_decode_is_correct(cell, tiny_config, tiny_sample_traffic):
    assert judged(cell, sample.run(cpu_context(tiny_config, tiny_sample_traffic))["numbers"])


@pytest.mark.parametrize("cell", ["d16-fid50", "d30-demo8"])
def test_a_token_altered_where_it_is_drawn(cell, tiny_config, tiny_sample_traffic, monkeypatch):
    import var_tpu_torch.engine.sampler as S

    draw = S.sample_with_top_k_top_p

    def altered(logits, *a, **kw):
        idx = draw(logits, *a, **kw)
        idx[0, 0] = (idx[0, 0] + 1) % logits.shape[-1]
        return idx

    monkeypatch.setattr(S, "sample_with_top_k_top_p", altered)
    assert not judged(cell, sample.run(cpu_context(tiny_config, tiny_sample_traffic))["numbers"])


@pytest.mark.parametrize("cell", ["d16-fid50", "d30-demo8"])
def test_an_image_altered_where_it_is_rendered(cell, tiny_config, tiny_sample_traffic,
                                               monkeypatch):
    import var_tpu_torch.engine.sampler as S

    render = S.render_fhat

    def altered(*a, **kw):
        img = render(*a, **kw)
        return torch.cat([1.0 - img[:1], img[1:]])

    monkeypatch.setattr(S, "render_fhat", altered)
    assert not judged(cell, sample.run(cpu_context(tiny_config, tiny_sample_traffic))["numbers"])


def test_a_sound_step_is_correct(tiny_config, tiny_train_traffic):
    assert judged("d16-train32", train.run(cpu_context(tiny_config, tiny_train_traffic))["numbers"])


def test_a_step_that_leaves_its_state_unchanged(tiny_config, tiny_train_traffic, monkeypatch):
    from var_tpu_torch.engine import trainer as tr

    monkeypatch.setattr(tr.AdamState, "update", lambda self, lr, wd, ok: None)
    numbers = train.run(cpu_context(tiny_config, tiny_train_traffic))["numbers"]
    assert numbers["change_gap"] == pytest.approx(1.0)
    assert not judged("d16-train32", numbers)


def test_half_of_the_batch_left_out(tiny_config, tiny_train_traffic, monkeypatch):
    from var_tpu_torch.engine import trainer as tr

    loss_of = tr.teacher_loss

    def half(var, vae, args, idx_bl, label, *a, **kw):
        h = label.shape[0] // 2
        return loss_of(var, vae, args, [t[:h] for t in idx_bl], label[:h], *a, **kw)

    monkeypatch.setattr(tr, "teacher_loss", half)
    assert not judged("d16-train32", train.run(cpu_context(tiny_config, tiny_train_traffic))[
        "numbers"])


@pytest.mark.parametrize("cell", ["d16-fid50", "d30-demo8"])
def test_a_filter_left_out(cell, tiny_config, tiny_sample_traffic, monkeypatch):
    import var_tpu_torch.engine.sampler as S

    draw = S.sample_with_top_k_top_p
    monkeypatch.setattr(S, "sample_with_top_k_top_p",
                        lambda logits, top_k=0, top_p=0.0, **kw: draw(logits, **kw))
    numbers = sample.run(cpu_context(tiny_config, tiny_sample_traffic))["numbers"]
    assert numbers["filter_share"] > Registry(ROOT).limits(cell)["filter_share"]
    assert not judged(cell, numbers)
