"""Matrix ingestion: the reference's CSR text cache, MatrixMarket, and the
ELL ``.npz`` cache (counterpart of ``mgpgcr_tpu/io``)."""

from mgpgcr_tpu_torch.io.matrix_market import read_matrix_market
from mgpgcr_tpu_torch.io.npz_cache import load_ell_npz, save_ell_npz
from mgpgcr_tpu_torch.io.parsed_txt import read_parsed_txt, write_parsed_txt

__all__ = [
    "read_parsed_txt",
    "write_parsed_txt",
    "read_matrix_market",
    "load_ell_npz",
    "save_ell_npz",
]
