"""Graph ingestion of the port: integer edge lists (text, ``.npz``),
Common Crawl metadata (TSV/JSONL) and Hadoop SequenceFiles, with the
JAX package's export list (``pagerank_tpu/ingest/__init__.py``)."""

from pagerank_tpu_torch.ingest.ids import (IdMap, records_to_arrays,
                                           records_to_graph)
from pagerank_tpu_torch.ingest.edgelist import (
    load_binary_edges,
    load_edgelist,
    load_edges_any,
    save_binary_edges,
)
from pagerank_tpu_torch.ingest.crawljson import (
    load_crawl_file,
    load_crawl_file_arrays,
    parse_metadata_record,
)
from pagerank_tpu_torch.ingest.seqfile import (
    load_crawl_seqfile,
    load_crawl_seqfile_arrays,
    read_sequence_file,
    write_sequence_file,
)

__all__ = [
    "IdMap",
    "records_to_arrays",
    "records_to_graph",
    "load_edgelist",
    "load_binary_edges",
    "load_edges_any",
    "save_binary_edges",
    "parse_metadata_record",
    "load_crawl_file",
    "load_crawl_file_arrays",
    "load_crawl_seqfile",
    "load_crawl_seqfile_arrays",
    "read_sequence_file",
    "write_sequence_file",
]
