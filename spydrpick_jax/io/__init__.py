from spydrpick_jax.io.fasta import read_fasta, write_fasta
from spydrpick_jax.io.loci import parse_loci_list, parse_value_list

__all__ = ["read_fasta", "write_fasta", "parse_loci_list", "parse_value_list"]
