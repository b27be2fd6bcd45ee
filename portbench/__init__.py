"""The benchmark of ``pna_tpu_torch`` on one H100: see ``README.md``."""
