"""The benchmark's yardstick for kernels: the card's peaks and the bytes
and operations each kernel's work needs, frozen so that a later change to
the port cannot move a roofline share by recounting its work."""
