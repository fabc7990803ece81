"""Importers of policies trained outside this package (counterpart of
`acas2d_tpu/compat/`)."""
