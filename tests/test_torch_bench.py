"""The benchmark twin (``pna_tpu_torch/bench.py``) against ``bench.py``, the
flat Adam against the per-tensor one and against ``optax.flatten``, and the
package's public names against the JAX package's.

``build_bench`` of both at 16 graphs, hidden 10, out 8, edge_dim 4, towers 2
(4 layers, as the bench has), the twin's weights carried from the JAX init by
``weights.from_jax``: the same real edges and nodes, then 3 steps of
``bench.py``'s jitted step with ``flat_opt=True`` against 3 of the twin's with
``FlatAdam``, on ``csr``/``pallas`` and ``csr_fused``/``pallas_fused`` (the
JAX kernels in interpret mode, as ``tests/test_torch_net.py`` runs them),
and ``bench.py``'s ``bucketed``, ``ell`` and ``auto`` (on its bucketed
batch) against the twin's ``csr``, ``csr`` and ``auto`` on its sorted one:
the port has no bucketed or ELL layout.  Tolerances, those of
``test_torch_net.py::test_adam_steps_match_optax``: losses rtol 1e-4; after
the steps every parameter and batch-norm statistic within 3 steps x 2 x lr
= 6e-3 (Adam turns float32 noise in a gradient near 0 into a step of up to
lr), and 99% of all entries within 1e-5.  The bf16 case holds the loss to
rtol 1e-2 (both sides round the same operands and sum in float32 in other
orders) and the parameters to the 6e-3 step bound.

The flat Adam against the per-tensor one: the same elementwise update, so 5
steps give parameters equal within 1e-7; against ``optax.flatten(optax.
adam)`` on the same gradients (a missing gradient is a zero one in both)
within 1 float32 rounding of the parameters, 1e-6."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench as jbench
import pna_tpu
import pna_tpu.nn
import pna_tpu.nn.nets as jnets
import pna_tpu.ops
import pna_tpu_torch
import pna_tpu_torch.nn
import pna_tpu_torch.ops
from pna_tpu_torch import bench
from pna_tpu_torch.train.step import FlatAdam, loss_and_grads, make_optimizer
from pna_tpu_torch.weights import from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
STEPS = 3
NARROW = dict(hidden_dim=10, out_dim=8, edge_dim=4, towers=2)
JAX_KERNEL = {'csr': 'pallas', 'csr_fused': 'pallas_fused'}
# the twin's backend for bench.py's layouts the port does not have
PORT_KERNEL = {'bucketed': 'csr', 'ell': 'csr'}


class _InterpretNet(jnets.PNANetMolecules):
    """The JAX net with its Pallas kernels in interpret mode (the CPU)."""
    pallas_interpret: bool = True


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _hold_params(got, want, bf16=False):
    diffs = []
    for k, w in want.items():
        d = np.abs(got[k].detach().numpy() - w.numpy())
        assert d.max() <= STEPS * 2 * LR, k
        diffs.append(d.ravel())
    if not bf16:
        assert np.quantile(np.concatenate(diffs), 0.99) < 1e-5


@pytest.mark.parametrize("kernel,bf16", [
    ('csr', False), ('csr_fused', False), ('bucketed', False),
    ('ell', False), ('auto', False), ('csr', True)])
def test_twin_steps_match_bench(monkeypatch, kernel, bf16):
    monkeypatch.setattr(jnets, 'PNANetMolecules', _InterpretNet)
    step_j, _, _, ne_j, nn_j, args = jbench.build_bench(
        16, kernel=JAX_KERNEL.get(kernel, kernel), flat_opt=True,
        compute_dtype=jnp.bfloat16 if bf16 else None, **NARROW)
    step, model, opt, _, n_edges, n_nodes = bench.build_bench(
        16, kernel=PORT_KERNEL.get(kernel, kernel), flat_opt=True,
        device='cpu',
        compute_dtype=torch.bfloat16 if bf16 else None, **NARROW)
    assert isinstance(opt, FlatAdam)
    assert (n_edges, n_nodes) == (ne_j, nn_j)
    params, stats, opt_state, graph, labels = args
    model.load_state_dict(from_jax(_np(params), _np(stats)))
    for i in range(STEPS):
        params, stats, opt_state, l_j = step_j(params, stats, opt_state,
                                               graph, labels)
        l_t = step()
        np.testing.assert_allclose(float(l_t), float(l_j),
                                   rtol=1e-2 if bf16 else 1e-4,
                                   err_msg=f"step {i}")
    _hold_params(model.state_dict(), from_jax(_np(params), _np(stats)),
                 bf16)


def _in_buffer(opt, model):
    lo = opt.flat.data_ptr()
    hi = lo + opt.flat.numel() * opt.flat.element_size()
    return all(lo <= p.data_ptr() < hi for p in model.parameters())


def test_flat_adam_equals_per_tensor_adam():
    """Five steps of the twin's step with FlatAdam and with torch.optim.Adam
    from the same seed: the same losses and parameters within 1e-7; the
    parameters stay views into the flat buffer after every step."""
    runs = [bench.build_bench(8, flat_opt=flat, device='cpu', **NARROW)
            for flat in (True, False)]
    (step_f, model_f, opt_f, *_), (step_p, model_p, opt_p, *_) = runs
    assert isinstance(opt_f, FlatAdam) and not isinstance(opt_p, FlatAdam)
    assert len(opt_f.param_groups[0]['params']) == 1
    assert opt_f.flat.numel() == sum(p.numel() for p in model_p.parameters())
    for _ in range(5):
        np.testing.assert_allclose(float(step_f()), float(step_p()),
                                   rtol=1e-7)
        assert _in_buffer(opt_f, model_f)
    for a, b in zip(model_f.parameters(), model_p.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-7)


def test_flat_adam_views_survive_zero_grad_step_and_load():
    """The parameters stay views into the flat buffer through
    ``loss_and_grads`` (``zero_grad(set_to_none=True)``), the optimiser's
    ``zero_grad``, ``step``, ``Module.load_state_dict`` and the optimiser's
    ``load_state_dict``; the loaded values are the ones a step then moves."""
    step, model, opt, (graph, labels), *_ = bench.build_bench(
        8, flat_opt=True, device='cpu', **NARROW)
    assert _in_buffer(opt, model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step()
    saved_opt = opt.state_dict()
    after_one = {k: v.clone() for k, v in model.state_dict().items()}
    loss_and_grads(model, graph, labels)
    assert all(p.grad is not None for p in model.parameters())
    opt.zero_grad()
    assert all(p.grad is None for p in model.parameters())
    assert _in_buffer(opt, model)
    model.load_state_dict(start)
    assert _in_buffer(opt, model)
    np.testing.assert_array_equal(
        opt.flat.detach().numpy(),
        torch.cat([p.detach().reshape(-1)
                   for p in model.parameters()]).numpy())
    # from the start again: the same first step
    fresh = make_optimizer(model, flat=True)
    assert _in_buffer(fresh, model)
    loss_and_grads(model, graph, labels)
    fresh.step()
    for k, v in after_one.items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    fresh.load_state_dict(saved_opt)
    assert _in_buffer(fresh, model)
    torch.testing.assert_close(fresh.state[fresh.flat]['exp_avg'],
                               saved_opt['state'][0]['exp_avg'])
    step_again = loss_and_grads(model, graph, labels)
    fresh.step()
    assert torch.isfinite(step_again) and _in_buffer(fresh, model)


def test_flat_adam_matches_optax_flatten():
    """FlatAdam against optax.flatten(optax.adam(1e-3)) on one gradient
    sequence, five steps; the second parameter has no gradient at step 2,
    a zero gradient in the optax tree."""
    rng = np.random.RandomState(3)
    init = {'a': rng.randn(3, 4).astype(np.float32),
            'b': rng.randn(5).astype(np.float32),
            'c': rng.randn(2, 2, 2).astype(np.float32)}
    tx = optax.flatten(optax.adam(LR))
    params = jax.tree_util.tree_map(jnp.asarray, init)
    state = tx.init(params)
    torch_params = [torch.nn.Parameter(torch.from_numpy(init[k].copy()))
                    for k in sorted(init)]
    opt = FlatAdam(torch_params, lr=LR)
    for i in range(5):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in init.items()}
        if i == 2:
            grads['b'] = np.zeros_like(init['b'])
        updates, state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        for k, p in zip(sorted(init), torch_params):
            p.grad = (None if i == 2 and k == 'b'
                      else torch.from_numpy(grads[k]))
        opt.step()
    for k, p in zip(sorted(init), torch_params):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_flat_adam_rejects_mixed_dtypes():
    with pytest.raises(ValueError, match="float32"):
        FlatAdam([torch.nn.Parameter(torch.zeros(2)),
                  torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))])


def _snapshot(path):
    """The regular files of ``path`` with their modification times
    (directories such as ``__pycache__`` change under other tests)."""
    return {entry.name: entry.stat().st_mtime_ns
            for entry in os.scandir(path) if entry.is_file()}


def test_main_prints_one_json_line(capsys, monkeypatch, tmp_path):
    """main on the CPU at a small size: exactly one JSON line with
    bench.py's keys, vs_baseline and mfu null, edges/s = real edges x 4 /
    step; the baseline file and the files of the repository's top level
    and of benchmarks/ unchanged, and no file written in the working
    directory."""
    monkeypatch.chdir(tmp_path)
    baseline = os.path.join(REPO, 'benchmarks', 'baseline_value.json')
    with open(baseline, 'rb') as f:
        base_bytes = f.read()
    before = (_snapshot(REPO), _snapshot(os.path.join(REPO, 'benchmarks')))
    out = bench.main(['--device', 'cpu', '--batch', '8', '--iters', '2',
                      '--repeats', '1', '--warmup', '1', '--hidden_dim',
                      '10', '--out_dim', '8', '--edge_dim', '4',
                      '--towers', '2'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(out))
    assert line['metric'] == 'pna_zinc_train_step_edges_per_sec_per_chip'
    assert line['unit'] == 'edges/sec' and line['vs_baseline'] is None
    d = line['detail']
    assert d['device'] == 'cpu' and d['flat_opt'] and d['kernel'] == 'csr'
    assert d['backends'] == ['csr'] * 4
    assert set(d['results']) == {'f32', 'bf16'}
    assert line['value'] == d['results']['bf16']['edges_per_sec']
    for name, r in d['results'].items():
        assert r['edges_per_sec'] == pytest.approx(
            d['n_edges'] * 4 / (r['step_ms'] / 1e3), rel=1e-9)
        assert r['mfu'] is None and r['busy'] is None
        assert r['device_ms_per_step'] is None
        assert r['matmul_dtype'] == ['float32']
        assert r['matmul_tflops_per_step'] > 0
        assert len(r['block_ms']) == len(r['block_start']) == 1
        assert r['launches_per_step'] == {
            'csr_moment_sketch': 0, 'csr_dmsg': 0,
            'csr_pretrans_sketch': 0, 'csr_pretrans_dmsg': 0,
            'sorted_row_sum': 0, 'csr_edge_message': 0}
        # FLOP step + warm-up + block + profile
        assert r['steps_run'] == 1 + 1 + 2 + bench.PROFILE_STEPS
    with open(baseline, 'rb') as f:
        assert f.read() == base_bytes
    assert (_snapshot(REPO), _snapshot(os.path.join(REPO, 'benchmarks'))) \
        == before
    assert os.listdir(tmp_path) == []


def test_run_config_and_interleaved_runners():
    """run_config (bench.py's single-configuration path), and two runners
    timed in turns, each keeping its own blocks."""
    r = bench.run_config(8, False, None, 'generic', 3, device='cpu')
    assert r['n_edges'] * 4 / (r['step_ms'] / 1e3) == pytest.approx(
        r['edges_per_sec'], rel=1e-9)
    assert len(r['block_ms']) == 3 and r['step_ms'] == min(r['block_ms'])
    a = bench.BenchRunner(8, True, None, 'auto', device='cpu', **NARROW)
    b = bench.BenchRunner(8, True, None, 'csr', device='cpu', flat_opt=True,
                          **NARROW)
    for _ in range(2):
        for runner in (a, b, b, a):
            runner.time_block(1)
    assert a.backends() == ['generic'] * 4 and b.backends() == ['csr'] * 4
    assert len(a.blocks) == len(b.blocks) == 4
    assert a.report()['spread_ms'] >= 0


@pytest.mark.parametrize("kernel", ['pallas', 'pallas_fused'])
def test_jax_kernel_names_raise(kernel):
    with pytest.raises(ValueError, match="csr"):
        bench.main(['--kernel', kernel, '--device', 'cpu'])
    with pytest.raises(ValueError, match="csr"):
        bench.build_bench(8, kernel=kernel, device='cpu')


@pytest.mark.parametrize("kernel", ['bucketed', 'ell'])
@pytest.mark.parametrize("entry", ['bench', 'largegraph'])
def test_tpu_layout_kernels_raise(entry, kernel):
    """The JAX package's bucketed and ELL backends, which the port does not
    have, are refused, naming the kernel, at the entry points that check a
    kernel name before building a layer: the twin's flag ("unknown kernel")
    and the large-graph trainer's ("not in KERNELS"; the layer's own check:
    tests/test_torch_fused_layer.py::test_unported_options_raise)."""
    from pna_tpu_torch.train import largegraph
    with pytest.raises(ValueError, match=f"kernel '{kernel}'"):
        if entry == 'bench':
            bench.main(['--kernel', kernel, '--device', 'cpu'])
        else:
            largegraph.build_problem(largegraph.LargeGraphConfig(
                kernel=kernel, num_nodes=50, num_edges=200), 'cpu')


@pytest.mark.parametrize("jax_mod,port_mod", [
    (pna_tpu, pna_tpu_torch), (pna_tpu.nn, pna_tpu_torch.nn),
    (pna_tpu.ops, pna_tpu_torch.ops)], ids=['package', 'nn', 'ops'])
def test_public_names_cover_the_jax_package(jax_mod, port_mod):
    assert set(jax_mod.__all__) <= set(port_mod.__all__)
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), name
