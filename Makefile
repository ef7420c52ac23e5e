# Convenience targets.
#   test       CPU suite (8 virtual devices), as CI runs it
#   gpu-lane   the GPU-marked tests, on a machine with an NVIDIA GPU
#   chip-smoke the one-card end-to-end smoke run (python chip_smoke.py)
#   bench      one-card SpMV + CG benchmark line (needs a GPU)
#   dryrun     the distributed hooks on 8 virtual CPU devices

.PHONY: test gpu-lane chip-smoke bench dryrun

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

gpu-lane:
	python -m pytest tests/ -m gpu -q

chip-smoke:
	python chip_smoke.py

bench:
	python bench.py

dryrun:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  python -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('ok')"
