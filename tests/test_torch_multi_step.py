"""The port's multi-step training on the CPU: ``make_multi_train_step``
against sequential ``make_train_step`` calls, the chunked ``train_epoch``
against eager steps, the resume that keeps every tensor in place (a CUDA
graph of the steps holds their addresses), the host-counter bookkeeping of
``utils/graph.py``, and the launch counters' rule for a captured launch. On CPU tensors the multi-step function runs its steps
eagerly, so every comparison here is bit for bit; the graph itself runs only
on the card (``chip_smoke.py`` ``train_graphed``)."""

import contextlib
import dataclasses
import types

import pytest
import torch

from nerf_tpu_torch.data.synthetic import make_procedural_dataset
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.train.trainer import (
    NeRFTrainer,
    init_train_state,
    make_multi_train_step,
    make_train_step,
)
from nerf_tpu_torch.utils import graph
from test_torch_train import tiny_config

HW = (32, 32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny config's tensors are too small to share between threads, and
    several test workers' thread pools fighting for the cores slow these
    loops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return make_procedural_dataset(n_views=8, img_wh=HW)


def _state_of(state, generator):
    opt = state.optimizer
    return {"leaves": [t.detach().clone() for t in state.leaves()],
            "mu": [t.clone() for t in opt.mu], "nu": [t.clone() for t in opt.nu],
            "counts": (opt.count, int(opt.device_count), state.step),
            "generator": generator.get_state()}


def _assert_same_state(a, b):
    for key in ("leaves", "mu", "nu"):
        assert len(a[key]) == len(b[key])
        for x, y in zip(a[key], b[key]):
            assert torch.equal(x, y), key
    assert a["counts"] == b["counts"]
    assert torch.equal(a["generator"], b["generator"])


def _views(ds):
    return (torch.as_tensor(ds.images), torch.as_tensor(ds.poses), float(ds.focal))


def test_multi_step_equals_sequential_steps(ds):
    cfg = tiny_config()
    images, poses, focal = _views(ds)
    order = [5, 0, 3]
    runs = []
    for multi in (False, True):
        state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
        gen = torch.Generator().manual_seed(7)
        if multi:
            metrics = make_multi_train_step(cfg, HW, 3)(state, images[order], poses[order], focal,
                                                        gen)
        else:
            step = make_train_step(cfg, HW)
            per_step = [step(state, images[i], poses[i], focal, gen) for i in order]
            metrics = {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}
        runs.append((_state_of(state, gen), metrics))
    (eager, m_eager), (multi, m_multi) = runs
    assert eager["counts"] == (3, 3, 3)
    _assert_same_state(eager, multi)
    assert set(m_multi) == {"loss", "loss_coarse", "loss_fine", "psnr"}
    for k, v in m_eager.items():
        assert m_multi[k].shape == (3,) and torch.equal(m_multi[k], v), k


def test_multi_step_refuses_a_chunk_of_another_size(ds):
    cfg = tiny_config()
    images, poses, focal = _views(ds)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="3 steps need 3 images"):
        make_multi_train_step(cfg, HW, 3)(state, images[:2], poses[:2], focal,
                                          torch.Generator().manual_seed(0))


@pytest.mark.parametrize("n_views, chunks", [(8, (3, 3, 2)), (7, (3, 3, 1))])
def test_train_epoch_in_chunks_equals_eager_steps(ds, n_views, chunks):
    # chunks of inner=3 images; a chunk of one is step_fn
    cfg = tiny_config()
    sub = make_procedural_dataset(n_views=n_views, img_wh=HW)
    chunked = NeRFTrainer(cfg, HW, device="cpu")
    mean = chunked.train_epoch(sub, inner=3)
    assert sorted(chunked._multi_step_cache) == sorted({k for k in chunks if k > 1})

    eager = NeRFTrainer(cfg, HW, device="cpu")
    images, poses, focal = _views(sub)
    losses = [eager.step_fn(eager.state, images[i], poses[i], focal, eager.generator)["loss"]
              for i in range(n_views)]
    _assert_same_state(_state_of(chunked.state, chunked.generator),
                       _state_of(eager.state, eager.generator))
    assert chunked.state.step == n_views
    assert mean == float(torch.stack(losses).mean())


def test_train_epoch_default_chunk_is_ten_or_the_dataset(ds):
    trainer = NeRFTrainer(tiny_config(), HW, device="cpu")
    trainer.train_epoch(ds)
    assert list(trainer._multi_step_cache) == [8] and trainer.state.step == 8


def test_load_checkpoint_keeps_every_tensor_in_place_and_resumes_bit_equal(ds, tmp_path):
    # a graph of the steps reads and writes the params, mu, nu and the device
    # count at their addresses, so a resume copies into them; then a trainer
    # resumed mid-run goes on as one that was never stopped
    cfg = dataclasses.replace(tiny_config(), checkpoint_dir=str(tmp_path))
    straight = NeRFTrainer(cfg, HW, device="cpu")
    straight.train_epoch(ds, inner=3)
    path = straight.save_checkpoint("mid.npz")
    gen_state = straight.generator.get_state()
    straight.train_epoch(ds, inner=3)

    resumed = NeRFTrainer(cfg, HW, device="cpu")
    opt = resumed.state.optimizer
    tensors = resumed.state.leaves() + opt.mu + opt.nu + [opt.device_count]
    ptrs = [t.data_ptr() for t in tensors]
    resumed.load_checkpoint(path)
    assert [t.data_ptr() for t in resumed.state.leaves() + opt.mu + opt.nu
            + [opt.device_count]] == ptrs
    assert opt.count == int(opt.device_count) == resumed.state.step == len(ds)
    assert float(opt.mu[0].abs().max()) > 0 and float(opt.nu[0].abs().max()) > 0
    resumed.generator.set_state(gen_state)
    resumed.train_epoch(ds, inner=3)
    _assert_same_state(_state_of(resumed.state, resumed.generator),
                       _state_of(straight.state, straight.generator))


def test_host_counters_put_back_after_capture_and_advance_on_replay():
    holder, opt = types.SimpleNamespace(step=5), types.SimpleNamespace(count=2)
    counters = graph.HostCounters([(holder, "step"), (opt, "count")])

    def stub_steps():                # what the Python of 3 steps does on the host
        holder.step += 3
        opt.count += 3
        return "out"

    out, delta = counters.record(stub_steps)
    assert out == "out" and delta == [3, 3]
    assert (holder.step, opt.count) == (5, 2)       # put back
    counters.advance(delta)
    counters.advance(delta)
    assert (holder.step, opt.count) == (11, 8)

    def failing():
        holder.step += 3
        raise RuntimeError("capture refused")

    with pytest.raises(RuntimeError, match="capture refused"):
        counters.record(failing)
    assert holder.step == 11


def test_graphed_call_counts_the_eager_call_and_each_replay(monkeypatch):
    # GraphedCall with the CUDA pieces stubbed: the first call runs the
    # function (its host effects stay), the capture runs it again (its host
    # effects are put back), each replay advances the counters by the
    # capture's advance and returns a copy of the captured outputs
    events = []

    class Stream:
        def wait_stream(self, other):
            events.append("wait")

    class Graph:
        def register_generator_state(self, g):
            events.append(("register", g))

        def replay(self):
            events.append("replay")

    capturing = []

    @contextlib.contextmanager
    def capture(g, pool=None):
        events.append(("pool", pool))
        capturing.append(True)
        yield
        capturing.pop()
        events.append("captured")

    class Out:
        def __init__(self, v):
            self.v = v

        def record_stream(self, s):
            events.append("record_stream")

        def clone(self):
            return Out(self.v)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())

    state = types.SimpleNamespace(step=0, count=0)
    runs = []

    def fn():
        runs.append(bool(capturing))
        state.step += 10
        state.count += 10
        return {"loss": Out(len(runs))}

    call = graph.GraphedCall(fn, graph.HostCounters([(state, "step"), (state, "count")]),
                             generators=["gen"], pool="shared")
    first = call()
    assert runs == [False, True]                     # eager, then the capture
    assert first["loss"].v == 1 and (state.step, state.count) == (10, 10)
    assert ("register", "gen") in events and "captured" in events
    assert ("pool", "shared") in events
    for n in (1, 2):
        out = call()
        assert out["loss"].v == 2 and out["loss"] is not call.out["loss"]
        assert (state.step, state.count) == (10 + 10 * n, 10 + 10 * n)
    assert runs == [False, True] and events.count("replay") == 2


@pytest.mark.parametrize("capturing", [False, True])
def test_a_launch_recorded_into_a_capture_adds_nothing_to_its_count(monkeypatch, capturing):
    # the kernels' launch counters count launches that ran: one recorded
    # into a CUDA graph adds 0 (its replays run it, which a trace counts),
    # so a capture leaves every counter as it was
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    assert _ext.ran() == (0 if capturing else 1)
