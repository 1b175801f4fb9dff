"""Model configurations of the port's serving paths (twin of
``repro.configs``): the full widths of the models it runs. The JAX
package's registry and dry-run are JAX lowering tools and have no twin."""
