"""The whole serving step's share of the card's peak: the run's images
per second times the model FLOPs of one served image (the reference's
decode of one image, one mapping and 1/n of an encode, counted on the
meta device) over the published dense peak in the configuration's
precision."""


def read(run):
    rate = run.rates.get("serve_images_per_s")
    if not rate:
        return None
    peak = run.peaks["flops_per_s"][run.precision]
    return 100.0 * rate * run.work["flops_per_image"] / peak
