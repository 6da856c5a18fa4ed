"""Benchmark of ``torchsparsegradutils_tpu_torch`` on one NVIDIA card.

``run.py`` is the entry; ``README.md`` says how cells, mixes and metrics
are added as data and files.  Nothing here imports JAX or the JAX
package.
"""
