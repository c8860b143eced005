"""Every dotted symbol a reference INI can name resolves through the
port's builder, in its bare and its ``neuralmonkey.``-prefixed form, as
``tests/test_reference_symbol_conformance.py`` holds for the JAX
package. The symbols of modules the port does not have yet
(``NOT_PORTED``, which the next slices shrink) raise the builder's
exception instead: a ``ConfigBuildException`` naming the section, over
an ``ImportError`` that says the symbol is not ported.
"""

import inspect

import pytest

from tests.test_reference_symbol_conformance import (REFERENCE_SYMBOLS,
                                                     TF_OPTIMIZER_SYMBOLS)

from neuralmonkey_tpu_torch.config.builder import (build_section,
                                                   resolve_class_symbol)
from neuralmonkey_tpu_torch.config.exceptions import ConfigBuildException
from neuralmonkey_tpu_torch.config.parsing import ClassSymbol

NOT_PORTED = [
    "encoders.imagenet_encoder.ImageNet",
    "readers.image_reader.image_reader",
    "readers.image_reader.imagenet_reader",
    "processors.wordpiece.WordpiecePreprocessor",
    "processors.wordpiece.WordpiecePostprocessor",
    "processors.german.GermanPreprocessor",
    "processors.german.GermanPostprocessor",
    "processors.helpers.preprocess_char_based",
    "processors.helpers.postprocess_char_based",
    "processors.helpers.untruecase",
    "processors.helpers.lowercase",
    "processors.helpers.pipeline",
    "processors.speech.audio_reader",
    "evaluators.chrf.ChrFEvaluator",
    "evaluators.f1_bio.F1Evaluator",
    "evaluators.sacrebleu.SacreBLEUEvaluator",
    "evaluators.ter.TEREvaluator",
    "evaluators.beer.BeerWrapper",
    "evaluators.multeval.MultEvalWrapper",
]
PORTED = [s for s in REFERENCE_SYMBOLS + TF_OPTIMIZER_SYMBOLS
          if s not in NOT_PORTED]


def _forms(symbols):
    return [form for symbol in symbols
            for form in (symbol, "neuralmonkey." + symbol)]


def test_not_ported_list_names_reference_symbols():
    assert set(NOT_PORTED) <= set(REFERENCE_SYMBOLS)


@pytest.mark.parametrize("symbol", _forms(PORTED))
def test_reference_symbol_resolves_into_the_port(symbol):
    obj = resolve_class_symbol(symbol)
    assert inspect.isclass(obj) or callable(obj), symbol
    assert obj.__module__.startswith("neuralmonkey_tpu_torch."), symbol
    assert obj is resolve_class_symbol(symbol.replace("neuralmonkey.", "",
                                                      1))


@pytest.mark.parametrize("symbol", _forms(NOT_PORTED))
def test_not_ported_symbol_raises_the_builders_exception(symbol):
    with pytest.raises(ConfigBuildException, match="section") as info:
        build_section("section", {"section": {"class": ClassSymbol(symbol)}},
                      {})
    assert isinstance(info.value.original_exception, ImportError)
    assert "is not ported" in str(info.value.original_exception)
