"""Distributed training: the ITC queue (`itc_queue`), process groups and
host-side gathers (`multihost`), the (data, model) mesh (`mesh`) and the
collectives of data-parallel steps (`data_parallel`)."""
