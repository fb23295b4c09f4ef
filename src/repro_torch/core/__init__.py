"""Emulation core: moduli, EFTs, Phase-1 splitting, Ozaki-II, reductions, dispatch."""
