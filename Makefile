# Dev automation (the counterpart of the reference's xtask CLI,
# /root/reference/xtask/src/main.rs: test / coverage / doc helpers).

PY ?= python

.PHONY: test test-fast bench lint coverage dryrun

test:            ## full suite on the virtual 8-device CPU mesh
	$(PY) -m pytest tests/ -q

test-fast:       ## engine + search structures only
	$(PY) -m pytest tests/test_engine.py tests/test_search.py \
	       tests/test_backward.py tests/test_mesh.py -q

bench:           ## node-expansion throughput on the default device (one JSON line)
	$(PY) bench.py

coverage:        ## branch coverage of the package (xtask coverage analogue)
	$(PY) -m pytest tests/ -q --cov=ddo_tpu --cov-report=term-missing 2>/dev/null \
	  || $(PY) -m pytest tests/ -q

dryrun:          ## single-device compile check + 8-virtual-device sharded step
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  $(PY) __graft_entry__.py
