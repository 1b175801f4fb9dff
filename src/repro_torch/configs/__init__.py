"""Model configurations of the port (twin of ``repro.configs``): the full
widths of the models it runs, and ``base.GNN_SHAPES``, the shapes the GNN
and MACE configs are built at. The JAX package's registry and dry-run are
JAX lowering tools and are not ported yet (ROADMAP A12.6)."""
