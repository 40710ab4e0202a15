"""Data model: holder, indexes, fields, views and fragments."""
