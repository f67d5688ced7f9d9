# Convenience targets (the reference ships shell wrappers around its
# CMake build; here the Python package needs no build step).

.PHONY: test test-all test-gpu bench smoke native clean

test:  ## fast default gate (skips `slow`-marked tests; < ~5 min)
	python -m pytest tests/ -q -m "not slow"

test-all:  ## the full suite, slow end-to-end tests included (parallel)
	python -m pytest tests/ -q -n auto

test-gpu:  ## the gpu-marked tests, on a machine with a CUDA card
	HFV_TESTS_ON_GPU=1 python -m pytest tests/ -q -m gpu

bench:
	python bench.py

smoke:  ## the GPU check: full-width scan, sweep and streamed search
	python chip_smoke.py

native:  ## optional C++ fast loader (the CUDA kernel builds on first use)
	$(MAKE) -C native

clean:
	rm -rf native/build .jax_cache
