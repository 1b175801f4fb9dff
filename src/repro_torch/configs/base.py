"""The GNN shapes of the JAX package's config registry (twin of the
``GNN_SHAPES`` table of ``repro.configs.base``): the published sizes each
GNN and MACE config is built and run at. The registry and its dry-run
cells are not ported yet."""

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2_708, n_edges=10_556, d_feat=1_433),
    "minibatch_lg": dict(
        n_nodes=232_965, n_edges=114_615_892, batch_nodes=1_024, fanout=(15, 10), d_feat=602
    ),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16),
}
