"""Examples of the port, run as modules:

* ``python -m torchsparsegradutils_tpu_torch.examples.distributed_stencil_solve``:
  CG over the halo-exchange matvec of a row-sharded 7-point stencil;
* ``python -m torchsparsegradutils_tpu_torch.examples.fit_conductivity_poisson``:
  an inverse screened-Poisson problem through ``sparse_generic_solve``'s
  implicit gradients;
* ``python -m torchsparsegradutils_tpu_torch.examples.fit_sparse_gmrf``:
  a sparse Gaussian Markov random field fitted by Adam through the
  precision-LDLᵀ ``log_prob``.

Each runs on the card; ``--cpu`` runs it on the CPU.
"""
