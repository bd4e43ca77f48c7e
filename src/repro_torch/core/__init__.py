"""Decoder core: features, lexicon, hypothesis unit, CTC beam search."""
