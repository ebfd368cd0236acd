"""User-facing optics model layer (mirrors, masks, sources, chains)."""
