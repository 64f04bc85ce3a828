"""The port's kernel tools: the variant sweep (`kernel_lab`) and the stage
profile and micro-probes (`microbench`), run as
`python -m ed25519_consensus_tpu_torch.tools.<name>`."""
