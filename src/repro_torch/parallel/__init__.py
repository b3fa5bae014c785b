"""Sharding over a ("data", "model") mesh: the JAX package's rules
(``sharding``), the logical activation annotations (``act``) and the
sharded train step's collectives on local tensors (``collectives``)."""
