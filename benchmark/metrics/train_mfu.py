"""The whole training step's share of the cards' peak: the run's trained
images per second times the reference's model FLOPs per trained image
(one R1 and path period, counted on the meta device:
``train_formulas.flops_per_image``) over the published dense peak of all
the run's cards in the configuration's precision."""


def read(run):
    rate = run.rates.get("train_images_per_s")
    if not rate or not run.work.get("flops_per_image"):
        return None
    peak = run.peaks["flops_per_s"][run.precision] * run.chips
    return 100.0 * rate * run.work["flops_per_image"] / peak
