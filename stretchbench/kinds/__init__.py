"""One module a kind of deployment (a deployment file's ``kind``).

A kind module gives ``make_stream(cfg, traffic, seed)`` (a
``streams.Stream``), ``make_pipeline(cfg, stream, device, wrap=None)``
(the port's ``VSNPipeline``, its state installed; ``wrap`` wraps the tick
function, for the tests' planted faults), ``Ref(cfg, stream, n_ticks)``
(the plain reference fed tick by tick with what the merge releases),
``canon(tau, payload)`` (an output lane as the reference writes it) and
``least_s(cfg, ref, ticks)`` (the least time of each layer's work).
"""
