"""PNANetSuperpixels on the receiver-sorted batch under ``kernel='csr'``
against the JAX net under ``kernel='auto'`` on its degree-bucketed batch of
the same graphs, on the same weights, at tests/test_torch_layout_nets.py's
float32 tolerances (its helpers)."""

import jax
import jax.numpy as jnp
import numpy as np

from pna_tpu.data import molecules as jmol
from pna_tpu.data import superpixels as jsp
from pna_tpu.nn.nets import PNANetSuperpixels as JSP
from pna_tpu_torch.data import molecules as tmol
from pna_tpu_torch.data import superpixels as tsp
from pna_tpu_torch.nn.nets import PNANetSuperpixels
from pna_tpu_torch.weights import from_jax
from tests.test_torch_layout_nets import _hold, _np
from tests.test_torch_superpixels import NET as SP_NET


def test_superpixel_net_on_bucketed_batch_matches_jax():
    """PNANetSuperpixels on superpixel graphs (float node and edge
    features, every node of degree 8), the JAX net on the JAX superpixel
    trainer's default layout, the bucketed batch, and the port's on its CSR
    batch: per-graph logits, loss and every gradient."""
    ds = tsp.SuperpixelsDataset.synthetic(n_train=6, n_val=1, n_test=1,
                                          seed=2, n_sp=14)
    recs = jsp.SuperpixelsDataset.synthetic(n_train=6, n_val=1, n_test=1,
                                            seed=2, n_sp=14).train
    kw = dict(SP_NET, in_dim=3, in_dim_edge=1, avg_d=ds.avg_d(),
              edge_feat=True, edge_dim=4)
    tg, tl = tmol.collate_records(ds.train)
    jg, jl = jmol.collate_records(recs, bucket_by_degree=True)
    assert jg.bucket_spec is not None and tg.edge_ptr is not None
    jnet = JSP(**kw, kernel='auto')
    var = _np(jnet.init({'params': jax.random.PRNGKey(0)}, jg,
                        jg.node_feats, jg.edge_feats, train=False))

    def loss_fn(p):
        out, _ = jnet.apply({'params': p, 'batch_stats': var['batch_stats']},
                            jg, jg.node_feats, jg.edge_feats, train=True,
                            mutable=['batch_stats'])
        return JSP.loss(out, jnp.asarray(jl), jg.graph_mask), out

    (l_j, out_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        var['params'])
    net = PNANetSuperpixels(**kw, kernel='csr', device='cpu')
    net.load_state_dict(from_jax(var['params'], var['batch_stats']))
    net.train()
    out = net(tg, tg.node_feats, tg.edge_feats)
    loss = PNANetSuperpixels.loss(out, tl, tg.graph_mask)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy()[:-1],
                               np.asarray(out_j)[:-1], rtol=1e-4, atol=1e-5)
    _hold(net, loss.detach(), float(l_j), from_jax(_np(g_j)))
