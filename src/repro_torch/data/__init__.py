"""Training data pipeline built on CkIO read sessions."""
from repro_torch.data.fileset import FileSet, ShardInfo, write_token_shards
from repro_torch.data.packing import (
    as_block_permutation,
    batch_from_tokens,
    pieces_in_arrival_order,
    row_gather_index,
    token_gather_from_pieces,
    window_rows,
)
from repro_torch.data.pipeline import CkIOPipeline
from repro_torch.data.synthetic import make_embedding_file, make_token_file
from repro_torch.data.tokenfile import TokenFileMeta, decode_rows, read_meta, write_token_file

__all__ = [
    "FileSet",
    "ShardInfo",
    "write_token_shards",
    "TokenFileMeta",
    "write_token_file",
    "read_meta",
    "decode_rows",
    "as_block_permutation",
    "batch_from_tokens",
    "pieces_in_arrival_order",
    "row_gather_index",
    "token_gather_from_pieces",
    "window_rows",
    "CkIOPipeline",
    "make_embedding_file",
    "make_token_file",
]
