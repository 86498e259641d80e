"""Orbit and map overlay: spherical geometry, SGP4, TLEs, shapefiles
and the overlay rasterizer, all host numpy/Python (a copy of
``noaa_apt_tpu/geo/``)."""

from .geometry import azimuth, distance, reckon
