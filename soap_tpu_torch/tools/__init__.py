"""The port's tools, one module for each of ``soap_tpu/tools/``.

The X-ray luminosity recalculation (``xray_calculator.py``) is the one
with device work.  The others read and write HDF5 with numpy on the
host, as the JAX tools do: catalogue compression and filter extraction
(``compression.py``), comparison (``compare.py``), the property-table
documentation (``docs.py``), virtual snapshots and empty catalogues
(``virtual_snapshot.py``), timing reports (``timing_analysis.py``),
membership checks and birth-halo indices (``membership_checks.py``),
property evolution along tracks (``track_evolution.py``), FOF ids across
particle orders (``reorder_fof.py``), halo matching across simulations
(``match_membership.py``), FOF radii and symmetric-matrix unpacking
(``fof_radii.py``), hydrogen species fractions (``hydrogen_phases.py``)
and the EAGLE-to-SWIFT conversion (``convert_eagle.py``).  Each imports
h5py and yaml only inside the functions that open files; where a tool
computes on what it reads, an array half does that without them.
"""
