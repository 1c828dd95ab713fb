"""Drivers of the traffic kinds (``traffic/<name>.json``'s ``kind``).

Each module has a ``Cell(spec, seed, device, log)`` with ``setup()`` (the
inputs from the seed, the program built and warmed, set-up's own part of
the output check), ``unit()`` (one step call or one request of the window,
not waited for), ``finish()`` (waits for the device), ``work(units)`` (the
rays and points of ``units`` units), ``release()`` (drops the program's
state) and ``check()`` (the numbers the output check compares). A kind
knows no model: the configuration's field (``spec.field``,
``fields/<field>.py``) builds the program, makes the weights, counts the
work and gives the reference its model.
"""
