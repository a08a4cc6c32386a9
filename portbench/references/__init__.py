"""Plain references, one file per kind of deployment, named by a
configuration's ``reference`` key.  They import neither the system under
test nor JAX."""
