from .fasta import iter_fasta, read_fasta, write_fasta
from .datasets import SimConfig, simulate_family, phi_dna, phi_rna, phi_protein
