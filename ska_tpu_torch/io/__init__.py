"""Host I/O of the port: FASTA/FASTQ parsing and the .skf codec."""
