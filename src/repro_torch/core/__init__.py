"""The i-vector system's core: UBM, alignment, Baum-Welch statistics, TVM
and the align -> stats chunk body."""
