"""Tokenizers (BERT WordPiece, CLIP byte-BPE)."""

from mammodissect_torch.models.tokenizers.bpe import ClipBPETokenizer
from mammodissect_torch.models.tokenizers.wordpiece import WordPieceTokenizer

__all__ = ["WordPieceTokenizer", "ClipBPETokenizer"]
