"""Device plumbing of the port: the mesh over a ``torch.distributed``
group and its collectives, deadline-bounded dispatch and liveness
(``mesh.py``), process-group bring-up (``distributed.py``), static edge
partitioning and the halo plan of the sparse boundary exchange
(``partition.py``), the dense, sparse and asynchronous comms models and
the load and head-K prediction (``comms.py``), and the elastic solve of
``pagerank_tpu/parallel/elastic.py`` over process groups (``elastic.py``:
the health monitor, the rescue runner with its roll call, regroup and
warm start; the group operations it needs are in ``distributed.py``)."""
